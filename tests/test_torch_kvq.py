"""Port parity of the quantized KV cache and of kernel B8's plain version.

- ``_kv_quant`` and ``_kv_quant4`` (the port's ``engine/generate.py``) give
  the JAX functions' int8 payloads and f32 scales bit for bit, on f32 and
  bf16 inputs, rows with exact round-half values and all-zero rows included;
  ``unpack4`` gives JAX's ``_unpack4`` planes.
- ``cached_qk``/``cached_pv`` (``ops/kvq_attention.py``) against the JAX
  ``_cached_qk``/``_cached_pv`` in every cache mode, and B8's plain version
  ``kvq_decode_attention_plain`` against the JAX decode block (the XLA path
  of ``_decode_token_forward``) and against the Pallas kernel
  ``kvq_decode_attention(..., interpret=True)``, within 1e-5 * max |want| in
  f32, at T a multiple of the Pallas tile and not, with ragged masks, a
  row that sees no cache key and a row with only its self term.
- The gate holds the controls ``chip_smoke.py`` runs on the card out: scales
  rolled by one position, nibble planes swapped, the self term dropped.
- The wrapper runs the plain version on CPU tensors and launches nothing;
  other devices raise; the CUDA source has its C entry, one kernel, and the
  ctypes argument list and the plan's constants match it.
- The kernel's plan (``key_tiles``): each cluster rank's run of the cache
  tiles that hold a valid key, on the decode layout (prefix | suffix |
  max_new tail), a window, an all-masked row and a ragged T, with clusters
  of 1 and 8; the plain version over only the planned tiles, rank by rank,
  joined as the cluster joins them, equals the full plain version; the
  wrapper's refusals, checked before anything is built.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmrankers_tpu.engine import generate as jgen
from llmrankers_tpu.ops.kvq_attention import kvq_decode_attention as jax_kvq
from llmrankers_tpu_torch.engine import generate as tgen
from llmrankers_tpu_torch.ops import _build
from llmrankers_tpu_torch.ops import kvq_attention as tkvq

MODES = [None, "int8", "int4"]
REL_TOL = 1e-5  # of max |want|, f32: summation order only


def _x(seed, shape, dtype=np.float32, scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    # Rows whose values sit on round-half boundaries of the quantizer, and an
    # all-zero row (amax floored at 1e-8).
    x[0, 0, 0, :] = np.linspace(-1.0, 1.0, shape[-1]) * 127.0
    x[0, 0, 1, :] = 0.0
    x[0, 0, 2, : shape[-1] // 2] = np.linspace(-3.5, 3.5, shape[-1] // 2)
    return x


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bit_identical_to_jax(mode, dtype):
    x = _x(0, (2, 3, 9, 64))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jgen._kv_pack(jx, mode)
    got_q, got_s = tgen._kv_pack(tx, mode)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_unpack4_matches_jax():
    q, _ = jgen._kv_quant4(jnp.asarray(_x(1, (2, 2, 5, 32))))
    lo_j, hi_j = jgen._unpack4(q, jnp.float32)
    lo_t, hi_t = tkvq.unpack4(torch.from_numpy(np.array(q)), torch.float32)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    assert set(np.unique(lo_t.numpy())) <= set(range(-7, 8))


def _operands(seed, B=3, KV=2, G=4, Dh=64, T=96, mode="int8"):
    """(JAX, torch) operands of one decode step: the cache quantized by the
    JAX functions, a ragged mask with a row that sees no cache key."""
    rng = np.random.RandomState(seed)
    qg = rng.randn(B, KV, G, Dh).astype(np.float32)
    k = (rng.randn(B, KV, T, Dh) * 2.0).astype(np.float32)
    v = (rng.randn(B, KV, T, Dh) * 2.0).astype(np.float32)
    kn = rng.randn(B, KV, Dh).astype(np.float32)
    vn = rng.randn(B, KV, Dh).astype(np.float32)
    if mode:
        kc = tuple(np.array(a) for a in jgen._kv_pack(jnp.asarray(k), mode))
        vc = tuple(np.array(a) for a in jgen._kv_pack(jnp.asarray(v), mode))
    else:
        kc, vc = k, v
    amask = np.zeros((B, T), bool)
    for b in range(B - 1):
        amask[b, 5 * b: T - 10 * b - 1] = True  # left and right holes
    # The last row sees no cache key: its output is its own v.
    j = tuple(jnp.asarray(a) for a in (qg, kn, vn, amask))
    t = tuple(torch.from_numpy(a) for a in (qg, kn, vn, amask))
    conv = (lambda c, f: tuple(f(a) for a in c) if isinstance(c, tuple) else f(c))
    jc = (conv(kc, jnp.asarray), conv(vc, jnp.asarray))
    tc = (conv(kc, torch.from_numpy), conv(vc, torch.from_numpy))
    return j, jc, t, tc


def _jax_block(qg, kc, vc, kn, vn, amask, scale, mode):
    """The JAX decode block (generate.py:613-640), as tests/test_kvq_attention.py
    writes it."""
    s = jgen._cached_qk(qg, kc, qg.dtype, mode, "bkgd,bktd->bkgt") * scale
    s = jnp.where(amask[:, None, None, :], s, jgen.NEG_INF)
    s_self = jnp.einsum("bkgd,bkd->bkg", qg, kn, preferred_element_type=jnp.float32) * scale
    m = jnp.maximum(jnp.max(s, axis=-1), s_self)
    p = jnp.exp(s - m[..., None])
    p_self = jnp.exp(s_self - m)
    z = p.sum(axis=-1) + p_self
    return (jgen._cached_pv(p, vc, qg.dtype, mode, "bkgt,bktd->bkgd")
            + p_self[..., None] * vn.astype(jnp.float32)[:, :, None, :]) / z[..., None]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_cached_dots_match_jax(mode):
    (qg, _, _, _), (kc, vc), (tq, _, _, _), (tkc, tvc) = _operands(2, mode=mode)
    s_j = jgen._cached_qk(qg, kc, jnp.float32, mode, "bkgd,bktd->bkgt")
    s_t = tkvq.cached_qk(tq, tkc, torch.float32, mode, "bkgd,bktd->bkgt")
    _close(s_t.numpy(), s_j)
    p = np.random.RandomState(3).rand(*s_j.shape).astype(np.float32)
    a_j = jgen._cached_pv(jnp.asarray(p), vc, jnp.float32, mode, "bkgt,bktd->bkgd")
    a_t = tkvq.cached_pv(torch.from_numpy(p), tvc, torch.float32, mode, "bkgt,bktd->bkgd")
    _close(a_t.numpy(), a_j)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("T", [96, 512, 640])
def test_plain_matches_jax_block_and_pallas_interpret(mode, T):
    """T 96 is below the Pallas tile, 512 one tile, 640 not a multiple of
    256 or 512 (the Pallas wrapper pads it)."""
    j, jc, t, tc = _operands(4, T=T, mode=mode)
    (qg, kn, vn, amask), (tq, tkn, tvn, tmask) = j, t
    scale = qg.shape[-1] ** -0.5
    got = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, scale, mode).numpy()
    _close(got, _jax_block(qg, *jc, kn, vn, amask, scale, mode))
    _close(got, jax_kvq(qg, *jc, kn, vn, amask, scale, mode, interpret=True))
    np.testing.assert_allclose(got[-1], np.repeat(np.asarray(vn)[-1][:, None], 4, 1),
                               rtol=1e-6, atol=1e-6)  # only the self term


def test_plain_bf16_cache_matches_jax_block():
    """A cache in the model's dtype (mode None) takes the same plain block."""
    j, jc, t, tc = _operands(5, mode=None)
    (qg, kn, vn, amask), (tq, tkn, tvn, tmask) = j, t
    got = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, 0.125, None)
    _close(got.numpy(), _jax_block(qg, *jc, kn, vn, amask, 0.125, None))


def test_controls_miss_the_gate():
    """What chip_smoke.py holds the kernel to separates the wrong answers it
    names: scales rolled by one position, nibble planes swapped, self term
    dropped (each differs by far more than the plain-vs-plain error)."""
    _, _, t, tc = _operands(6, T=200, mode="int4")
    tq, tkn, tvn, tmask = t
    tq = tq * 3.0  # peaked attention, as a trained model's
    args = (tkn, tvn, tmask, 0.125, "int4")
    want = tkvq.kvq_decode_attention_plain(tq, *tc, *args)
    roll = [(c[0], c[1].roll(1, dims=2)) for c in tc]
    swap = [(((c[0].int() & 0x0F) << 4 | (c[0].int() >> 4) & 0x0F).to(torch.int8), c[1])
            for c in tc]
    no_self = tkvq.kvq_decode_attention_plain(
        tq, *tc, tkn, tvn, tmask & False, 0.125, "int4")  # only the self term
    for bad in (tkvq.kvq_decode_attention_plain(tq, *roll, *args),
                tkvq.kvq_decode_attention_plain(tq, *swap, *args), no_self):
        assert (bad - want).abs().max().item() > 0.05


def test_wrapper_on_cpu_and_other_devices():
    _, _, t, tc = _operands(7, mode="int8")
    tq, tkn, tvn, tmask = t
    n = tkvq.kvq_decode_attention.launches
    got = tkvq.kvq_decode_attention(tq, *tc, tkn, tvn, tmask, 0.125, "int8")
    want = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, 0.125, "int8")
    assert torch.equal(got, want) and tkvq.kvq_decode_attention.launches == n
    meta = [x.to("meta") for x in (tq, tkn, tvn, tmask)]
    mc = [(c[0].to("meta"), c[1].to("meta")) for c in tc]
    with pytest.raises(ValueError, match="no kernel for device"):
        tkvq.kvq_decode_attention(meta[0], *mc, *meta[1:], 0.125, "int8")
    with pytest.raises(ValueError, match="unknown mode"):
        tkvq.kvq_decode_attention(tq, *tc, tkn, tvn, tmask, 0.125, None)


def test_kvq_source_has_its_entry_point():
    """B8 is a hand-written CUDA source with one C entry and one kernel (no
    combine pass, no workspace); the wrapper's ctypes argument list and the
    constants its plan mirrors match the source."""
    with open(os.path.join(_build.CSRC_DIR, "kvq_decode.cu")) as f:
        src = f.read()
    sig = src.split('extern "C" int kvq_decode_bf16(')[1].split(")")[0]
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = ["ptr" if "*" in p or p.startswith("cudaStream_t") else p.split()[0]
             for p in params]
    assert kinds == ["ptr"] * 9 + ["int"] * 7 + ["float", "ptr"]
    assert src.count("__global__") == 1 and "kvq_decode_kernel" in src
    assert "combine" not in src and "ws" not in params
    for name, value in (("TILE", tkvq.TILE), ("STAGES", tkvq.STAGES),
                        ("MAX_CLUSTER", tkvq.MAX_CLUSTER), ("MAXG", tkvq.MAX_GROUP),
                        ("SMEM_LIMIT", tkvq.SMEM_LIMIT)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "static_assert(SMEM_LIMIT / 10 < 65536" in src  # uint16 tile indices
    # The shared-memory attribute is raised in one helper that the launch and
    # the occupancy query share, so neither lowers what the other set.
    assert src.count("cudaFuncAttributeMaxDynamicSharedMemorySize") == 1
    assert src.count("allow_smem<DH, INT4>(smem)") == 2
    for piece in ("cp.async.bulk.shared::cluster.global", "mbarrier.try_wait", "trap;",
                  "map_shared_rank", "cluster.sync()", "cudaLaunchAttributeClusterDimension",
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "cudaGetLastError"):
        assert piece in src, piece
    for lib in ("cublas", "cudnn", "scaled_dot_product"):
        assert lib not in src.lower()


def test_trace_tool_finds_its_anchors():
    """chip_kvq_trace.py stamps a copy of the kernel at lines of its code:
    each anchor is found once, every stamp goes in, and the output write is
    dropped (the stamps own the output)."""
    spec = importlib.util.spec_from_file_location(
        "chip_kvq_trace", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_kvq_trace.py"))
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    src = trace.traced_source()
    for k in range(8):
        assert src.count(f"KVQ_STAMP({k})") == 1, k
    assert src.count("KVQ_TIME(0)") == src.count("KVQ_TIME(1)") == 1
    assert "= A / L;" not in src and src.count("__global__") == 1


def _decode_row(T, prefix_slots, prefix_len, suffix_len, new, decoded):
    """A decode key-mask row in the shared path's layout: prefix bucket (its
    first ``prefix_len`` slots real) | suffix area (``suffix_len`` real) |
    ``new`` tail slots (``decoded`` written)."""
    row = np.zeros(T, bool)
    row[:prefix_len] = True
    row[prefix_slots:prefix_slots + suffix_len] = True
    row[T - new:T - new + decoded] = True
    return row


def _rows(layout):
    if layout == "decode":  # chip_smoke's T 2304: 1536 | 640 | 128
        return 2304, _decode_row(2304, 1536, 1200, 397, 128, 64)
    if layout == "window":  # the same, the last 512 valid keys only
        T, row = 2304, _decode_row(2304, 1536, 1200, 397, 128, 64)
        cum = np.cumsum(row) - 1
        return T, row & (row.sum() - cum <= 512)
    if layout == "all_masked":
        return 200, np.zeros(200, bool)
    # ragged T (not a multiple of the tile), left padding, holes
    T = 1000
    row = np.arange(T) >= 333
    row[700:790] = False
    return T, row


@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("layout", ["decode", "window", "all_masked", "ragged"])
def test_key_tiles_plan(layout, cluster):
    T, row = _rows(layout)
    runs = tkvq.key_tiles(row, T, cluster)
    assert len(runs) == cluster
    flat = [t for run in runs for t in run]
    want = [t for t in range(tkvq.n_tiles(T)) if row[t * tkvq.TILE:(t + 1) * tkvq.TILE].any()]
    assert flat == want  # every tile with a valid key, once, in order; no other
    sizes = [len(run) for run in runs]
    assert max(sizes) - min(sizes) <= 1  # balanced by valid tiles
    if layout == "decode":
        # prefix 1200 of 1536: tiles 19-23 are padding; the suffix's 397 of
        # 640: tiles 31-33; the tail's 64 unwritten slots: tile 35
        assert set(range(tkvq.n_tiles(T))) - set(flat) == {19, 20, 21, 22, 23, 31, 32, 33, 35}
    if layout == "window":
        # 64 decoded, the suffix's 397 and the prefix's last 51 keys
        assert flat == [17, 18, 24, 25, 26, 27, 28, 29, 30, 34]
    if layout == "all_masked":
        assert flat == []
    if layout == "ragged":
        assert tkvq.n_tiles(T) == 16 and flat[-1] == 15 and 11 not in flat


def _join_planned(qg, kc, vc, kn, vn, amask, scale, mode, cluster):
    """The plain version over only the tiles the plan gives each cluster
    rank, each rank's (max, sum, acc) joined with the self term as the
    kernel's rank 0 joins them."""
    B, KV, G, Dh = qg.shape
    T = kc[0].shape[2]
    s_self = tkvq._dot("bkgd,bkd->bkg", qg, kn) * scale
    out = torch.zeros(B, KV, G, Dh)
    for b in range(B):
        parts = []
        for run in tkvq.key_tiles(amask[b].tolist(), T, cluster):
            keys = [k for t in run for k in range(t * tkvq.TILE, min(T, (t + 1) * tkvq.TILE))]
            if not keys:
                continue
            idx = torch.tensor(keys)
            sub = lambda c: (c[0][b:b + 1, :, idx], c[1][b:b + 1, :, idx])  # noqa: E731
            s = tkvq.cached_qk(qg[b:b + 1], sub(kc), qg.dtype, mode, "bkgd,bktd->bkgt") * scale
            s = s.masked_fill(~amask[b:b + 1, idx][:, None, None, :], tkvq.NEG_INF)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            acc = tkvq.cached_pv(p, sub(vc), qg.dtype, mode, "bkgt,bktd->bkgd")
            parts.append((m[0], p.sum(-1)[0], acc[0]))
        M = s_self[b]
        for m, _, _ in parts:
            M = torch.maximum(M, m)
        e = torch.exp(s_self[b] - M)
        L, A = e, e[..., None] * vn[b].float()[:, None, :]
        for m, l, acc in parts:
            f = torch.exp(m - M)
            L, A = L + l * f, A + f[..., None] * acc
        out[b] = A / L[..., None]
    return out


@pytest.mark.parametrize("cluster", [1, 3, 8])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_plain_over_planned_tiles_equals_plain(mode, cluster):
    """Only the planned tiles, split as the cluster splits them, give the full
    plain version, to 2e-3 of max |want|: each rank rounds p (times the v
    scale) to bf16 against its own running max, the full version against
    the row's, so each weight is rounded differently (bf16 keeps 8
    significant bits: up to 2^-8 of it each way)."""
    _, _, t, tc = _operands(12, B=4, T=300, mode=mode)
    tq, tkn, tvn, tmask = t
    tmask = tmask.clone()
    tmask[0] = torch.from_numpy(_decode_row(300, 128, 100, 90, 44, 20))
    tmask[1, :] = False
    tmask[1, 64:128] = True  # one tile
    scale = 64**-0.5
    want = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, tmask, scale, mode)
    got = _join_planned(tq, *tc, tkn, tvn, tmask, scale, mode, cluster)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-3 * want.abs().max().item())


def test_plan_controls_miss_the_gate():
    """chip_smoke.py's plan controls separate wrong answers: with one valid
    tile, the output computed with that tile dropped (only the self term),
    and at the decode layout the output with one cluster rank's partial left
    out, each differ from the plain version by more than the gate."""
    _, _, t, tc = _operands(13, B=2, KV=2, G=8, Dh=128, T=640, mode="int8")
    tq, tkn, tvn, tmask = t
    tq = tq * 3.0
    scale = 128**-0.5
    one = torch.zeros_like(tmask)
    one[:, 128:192] = True
    want = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, one, scale, "int8")
    dropped = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, one & False, scale, "int8")
    assert (dropped - want).abs().max().item() > 0.05
    mask = torch.ones_like(tmask)
    want = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, mask, scale, "int8")
    runs = tkvq.key_tiles(mask[0].tolist(), 640, 8)
    gone = mask.clone()
    for t_ in runs[3]:
        gone[:, t_ * tkvq.TILE:(t_ + 1) * tkvq.TILE] = False
    left_out = tkvq.kvq_decode_attention_plain(tq, *tc, tkn, tvn, gone, scale, "int8")
    assert (left_out - want).abs().max().item() > 0.05


def test_smem_bytes_and_cluster_size():
    # The ring (6 stages of K and V tiles and their scale rows), then 8 bytes
    # of key bits and a uint16 list entry per tile.
    assert tkvq._smem_bytes(128, False, 2304) == 6 * 2 * 64 * (128 + 4) + 10 * 36
    assert tkvq._smem_bytes(128, True, 4224) == 6 * 2 * 64 * (64 + 8) + 10 * 66
    assert tkvq._smem_bytes(64, False, 1) == 6 * 2 * 64 * (64 + 4) + 10
    assert tkvq._smem_bytes(128, False, 4096 * 64) <= tkvq.SMEM_LIMIT
    # Batch 8 with 2 KV heads: clusters of 8, 128 blocks for 132 SMs; one
    # block per (b, kv) where B*KV fills the card; never more blocks than tiles.
    assert tkvq.cluster_size(8, 2, 2304, 132) == 8
    assert tkvq.cluster_size(1, 2, 2304, 132) == tkvq.MAX_CLUSTER
    assert tkvq.cluster_size(32, 8, 2304, 132) == 1
    assert tkvq.cluster_size(8, 2, 130, 132) == 3
    assert tkvq.cluster_size(16, 2, 2304, 132) == 4


def _refusal_case(case):
    _, _, t, tc = _operands(14, B=2, KV=2, G=4, Dh=64, T=96, mode="int8")
    tq, tkn, tvn, tmask = (x.bfloat16() if x.is_floating_point() else x for x in t)
    kc, vc = tc
    if case == "dh":
        tq = torch.zeros(2, 2, 4, 96, dtype=torch.bfloat16)
    elif case == "group":
        tq = torch.zeros(2, 2, 9, 64, dtype=torch.bfloat16)
    elif case == "q_dtype":
        tq = tq.float()
    elif case == "payload_layout":
        kc = (torch.zeros(2, 2, 96, 128, dtype=torch.int8)[..., :64], kc[1])
    elif case == "scales_dtype":
        vc = (vc[0], vc[1].double())
    elif case == "mask_shape":
        tmask = tmask[:, :64]
    elif case == "k_new_shape":
        tkn = tkn[:, :1]
    return tq, kc, vc, tkn, tvn, tmask


@pytest.mark.parametrize("case, match", [
    ("dh", "Dh 64 or 128"), ("group", "group of 1 to 8"), ("q_dtype", "q must be"),
    ("payload_layout", "k payload must be contiguous"), ("scales_dtype", "v scales must be"),
    ("mask_shape", "amask must be"), ("k_new_shape", "k_new must be")])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The checks the wrapper runs before it builds or launches (on CPU
    tensors here, where the wrapper itself takes the plain version)."""
    with pytest.raises(ValueError, match=match):
        tkvq._operands(*_refusal_case(case), "int8")


def test_wrapper_refuses_a_cache_beyond_shared_memory():
    """Hundreds of thousands of positions: the ring and 10 bytes a tile
    (key bits, the uint16 tile list) must fit in shared memory."""
    for dh, int4, top in ((64, True, 19000), (128, False, 12000)):
        tkvq._check_shape(dh, 8, top * tkvq.TILE, int4)
        with pytest.raises(ValueError, match="fits in"):
            tkvq._check_shape(dh, 8, (top + 1000) * tkvq.TILE, int4)
    with pytest.raises(ValueError, match="at least one position"):
        tkvq._check_shape(128, 8, 0, False)
    with pytest.raises(ValueError, match="group of 1 to 8"):
        tkvq._check_shape(128, 0, 64, False)
