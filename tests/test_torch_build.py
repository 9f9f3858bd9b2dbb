"""The port's kernel build (``llmrankers_tpu_torch/ops/_build.py``) on a
machine without nvcc or a GPU: a failed build raises with the compiler's
output, and the build key follows the sources and flags."""
import os
import stat

import pytest

from llmrankers_tpu_torch.ops import _build, int8_matmul


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_missing_nvcc_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_blhd")


def test_failed_build_raises_with_compiler_output(fresh_build, monkeypatch):
    fake = fresh_build / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match=r"(?s)exit 3.*no sm_90a here"):
        _build.load("flash_blhd")
    assert not any(n.endswith(".so") for n in os.listdir(_build.BUILD_DIR))


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = _build._digest()
    assert key == _build._digest()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest() != key
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "flash_blhd.cu"))


def _source(*names):
    text = ""
    for name in names:
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text += f.read()
    return text


def test_int8_source_has_its_entry_points():
    """The W8A8 kernels are one hand-written source with four C entry points
    (B3, B4, B6, B9) on int8 wgmma, with the quantize pass from the shared
    header; no Ampere-era mma.sync is left in either."""
    src = _source("int8_fusedq.cu")
    for entry in ("quantized_matmul_bf16", "gated_matmul_bf16", "gated_matmul_pair_bf16",
                  "int8_matmul_bf16"):
        assert f'extern "C" int {entry}(' in src
    assert '#include "int8_quantize.cuh"' in src
    assert "quantize_blocks_kernel" in _source("int8_quantize.cuh")
    assert "mma.sync" not in src + _source("int8_quantize.cuh")
    assert "cublas" not in (src + _source("int8_quantize.cuh")).lower()


def test_b3_runs_on_a_wgmma_kernel_fed_by_tma():
    """B3's entry launches the quantize pass and the int8 wgmma kernel: s8
    m64n128k32 products from shared-memory descriptors, both operands by 2-D
    TMA under the 128-byte swizzle through an mbarrier ring of at least four
    stages fed by a producer warp, the per-K-block fold in round-to-nearest
    steps, the output tile stored by TMA; the role branch on a warp index
    broadcast from lane 0 and the wait loop inside one asm block (a
    divergent path makes ptxas serialise the wgmmas); B4's and B6's entries
    reach the same launcher, and B9's too."""
    src = _source("int8_fusedq.cu")
    hdr = _source("int8_wgmma.cuh")
    for inc in ('#include "int8_wgmma.cuh"', '#include "tma_encode.cuh"'):
        assert inc in src
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in hdr
    for ptx in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity", "wgmma.wait_group",
                "wgmma.fence", "wgmma.commit_group"):
        assert ptx in hdr, ptx
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src and "CU_TENSOR_MAP_DATA_TYPE_UINT8" in src
    stages = int(src.split("constexpr int kWgStages = ")[1].split(";")[0])
    assert stages >= 4
    b3 = src.split('extern "C" int quantized_matmul_bf16(')[1].split('extern "C"')[0]
    assert "launch_wgmma(" in b3 and "launch(" not in b3.replace("launch_wgmma(", "")
    loop = src.split("void consume(")[1].split("\n}\n")[0]  # the wgmma kernels' mainloop
    assert "__fadd_rn(accf[q], __fmul_rn(__int2float_rn(acc[q]), sc[h]))" in loop
    assert "s8wg::mma_n128(" in loop and "s8wg::wait<1>()" in loop
    body = src.split("int8_gemm_wgmma_kernel(")[1].split("int8_gated_wgmma_kernel(")[0]
    assert "consume(accf, ring, cw, r0, p);" in body
    assert "mma_s8(" not in body + loop and "ldmatrix" not in body + loop
    assert "__shfl_sync(0xffffffffu, tid / 32, 0)" in body and "tma_store_2d(" in body
    wait = hdr.split("void mbar_wait(")[1].split("\n}\n")[0]
    assert "while" not in wait and "mbarrier.try_wait.parity" in wait and "trap;" in wait
    assert "cp.async.bulk.tensor.2d.global.shared::cta" in hdr
    for entry in ("gated_matmul_bf16", "gated_matmul_pair_bf16"):
        rest = src.split(f'extern "C" int {entry}(')[1].split('extern "C"')[0]
        assert "launch_wgmma(" in rest and "launch_gemm(" not in rest
    b9 = src.split('extern "C" int int8_matmul_bf16(')[1]
    assert "launch_wgmma(" in b9 and "launch_gemm(" not in b9
    assert src.count("__global__") == 2  # B3's (B9's too) and the gated kernel


def test_b9_runs_on_b3s_wgmma_kernel():
    """B9's entry reaches B3's launcher with no bf16 x, so no quantize pass
    runs, one K-block of K (kb = K: all K/128 stages into one int32 sum, one
    fold) and its K-major weight as B3's single B map; the launcher skips
    the quantize pass only when x is null. Nothing of the mma.sync body is
    left under csrc/."""
    src = _source("int8_fusedq.cu")
    b9 = src.split('extern "C" int int8_matmul_bf16(')[1].split("\n}\n")[0]
    assert "wg_params(sx, sw, out, M, K, N, K);" in b9  # nk 1, per_block K / 128
    assert "launch_wgmma(nullptr, static_cast<const int8_t*>(w8), nullptr, N, p," in b9
    assert "K, K," in b9 and "launch_quantize" not in b9
    launcher = src.split("int launch_wgmma(")[1].split("\n}\n")[0]
    assert "if (x != nullptr) err = launch_quantize(" in launcher
    assert launcher.count("launch_quantize(") == 1
    for entry in ("quantized_matmul_bf16", "gated_matmul_bf16", "gated_matmul_pair_bf16"):
        rest = src.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
        assert "launch_wgmma(static_cast<const __nv_bfloat16*>(x)," in rest, entry
    assert src.count("__global__") == 2
    every = _source(*sorted(n for n in os.listdir(_build.CSRC_DIR)
                            if n.endswith((".cu", ".cuh"))))
    for gone in ("mma_s8", "ldmatrix", "store_b_transposed", "int8_gemm_kernel",
                 "launch_gemm", "GemmParams"):
        assert gone not in every, gone
    assert not os.path.exists(os.path.join(_build.CSRC_DIR, "int8_mma.cuh"))


def test_b4_b6_run_on_one_gated_wgmma_kernel():
    """B4 and B6 run one wgmma kernel on B3's mainloop: per stage the A box
    and the B tile as two 64-row boxes (w0's rows over w1's, from row
    w1_row + n0: B4's [2N, K] map at N, B6's second map at 0), the shared
    fold, and an epilogue that pairs accumulator column c (x . w0) with
    c + 64 (x . w1) as act(h0 * s0) * (h1 * s1) in round-to-nearest steps,
    one 64-column panel per warpgroup stored by TMA; blocks in groups of row
    tiles, row tiles fastest; no gated mma.sync body is left."""
    src = _source("int8_fusedq.cu")
    body = src.split("int8_gated_wgmma_kernel(")[1].split("CUresult encode_2d(")[0]
    assert "int8_gemm_wgmma" not in body  # profilers tell B3's launches by that name
    assert body.count("s8wg::tma_2d(") == 3
    assert "s8wg::tma_2d(st + kWgTile, &tb0, ring.full + 8 * s, i * kWgK, n0);" in body
    assert ("s8wg::tma_2d(st + kWgTile + kWgTile / 2, &tb1, ring.full + 8 * s, i * kWgK,\n"
            "                     p.w1_row + n0);") in body
    assert "s8wg::mbar_expect_tx(ring.full + 8 * s, kWgStage);" in body
    assert "consume(accf, ring, cw, r0, p);" in body
    for step in ("const float h0 = __fmul_rn(accf[4 * j + 2 * h + e], s0v[2 * j + e]);",
                 "const float h1 = __fmul_rn(accf[4 * (j + 8) + 2 * h + e], s1v[2 * j + e]);",
                 "o[e] = __fmul_rn(activate(p.act, h0), h1);"):
        assert step in body, step
    assert body.count("s8wg::tma_store_2d(") == 1
    assert "__shfl_sync(0xffffffffu, tid / 32, 0)" in body
    assert "m0 = (first + in_group % rows) * kWgRows" in body  # row tiles fastest in a group
    assert "constexpr int kGatedCols = 64;" in src and "const int box = cols;" in src
    b4 = src.split('extern "C" int gated_matmul_bf16(')[1].split('extern "C"')[0]
    assert "p.w1_row = N;" in b4 and "w, w, 2 * N, p," in b4
    b6 = src.split('extern "C" int gated_matmul_pair_bf16(')[1].split('extern "C"')[0]
    assert "static_cast<const int8_t*>(w1), N, p," in b6 and "w1_row" not in b6
    for gone in ("GATED", "tile_col", "int8_gemm_kernel<true>", "template <bool", "ldw"):
        assert gone not in src, gone


@pytest.mark.parametrize("entry", sorted(int8_matmul.ENTRIES))
def test_int8_wrapper_argtypes_match_the_c_entries(entry):
    """The ctypes argument list of each W8A8 entry (pointers, ints, stream)
    matches its ``extern "C"`` signature, type for type."""
    src = _source("int8_fusedq.cu")
    sig = src.split(f'extern "C" int {entry}(')[1].split(")")[0]
    params = [" ".join(p.split()) for p in sig.split(",")]
    want = [int8_matmul.ctypes.c_void_p if "*" in p else int8_matmul.ctypes.c_int
            for p in params]
    assert all("*" in p or p.startswith("int ") for p in params), params
    assert int8_matmul.ENTRIES[entry] == want


def test_int4_source_has_its_entry_point():
    """B7 is its own hand-written source on the same int8 tensor-core tiles:
    the quantize pass, then the two nibble planes as 16 * lo4 and 16 * hi4
    and the exact 1/16 in the fold."""
    src = _source("int4_w4a8.cu")
    assert 'extern "C" int quantized_matmul_int4_bf16(' in src
    assert '#include "int8_quantize.cuh"' in src
    assert "0xF0F0F0F0u" in src and "0x80808080u" in src and "0.0625f" in src
    assert "cublas" not in src.lower() and "_int_mm" not in src


def test_b7_runs_on_a_wgmma_kernel_fed_by_tma():
    """B7's entry launches the quantize pass and one int8 wgmma kernel: s8
    m64n128k32 products from shared-memory descriptors under the 64-byte
    swizzle, the packed weight, both x8 planes and the group scales by 2-D
    TMA through an mbarrier ring of at least four stages, the nibbles
    expanded in shared memory and handed to wgmma through the async-proxy
    fence, one int32 sum per group folded in round-to-nearest steps, the
    output tile stored by TMA; the role branch on a warp index broadcast from
    lane 0 (a divergent path makes ptxas serialise the wgmmas); no mma.sync,
    no ldmatrix, no transposed staging."""
    src = _source("int4_w4a8.cu")
    for inc in ('#include "int8_wgmma.cuh"', '#include "tma_encode.cuh"'):
        assert inc in src
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in src and "CU_TENSOR_MAP_DATA_TYPE_UINT8" in src
    stages = int(src.split("constexpr int kStages = ")[1].split(";")[0])
    assert stages >= 4
    body = src.split("w4a8_gemm_wgmma_kernel(")[1].split("CUresult encode_2d(")[0]
    for call in ("s8wg::mma_n128(", "s8wg::tma_2d(", "s8wg::tma_store_2d(",
                 "s8wg::mbar_wait(", "s8wg::fence_async_smem()", "s8wg::wait<1>()"):
        assert call in body, call
    assert body.count("s8wg::tma_2d(") == 4  # packed, x8 lo, x8 hi, sw
    assert "for (int kk = 0; kk < 4; ++kk)" in body and "step > 0 || kk > 0" in body
    assert "__shfl_sync(0xffffffffu, tid / 32, 0)" in body
    assert ("accf[q] = __fadd_rn(accf[q], __fmul_rn(__fmul_rn(d, sc[h]), e ? sw.y : sw.x))"
            in body)
    assert "__fmul_rn(__int2float_rn(acc[q]), 0.0625f)" in body
    for gone in ("mma_s8(", "ldmatrix", "store_b_transposed", "p.z", "acc[2]"):
        assert gone not in src, gone
    assert "int* z" not in _source("int8_quantize.cuh")  # no zero-point sums
    desc = _source("int8_wgmma.cuh").split("uint64_t desc_k64(")[1].split("\n}\n")[0]
    assert "512 >> 4" in desc and "(2) << 62" in desc  # 8 rows of 64 B; 64-byte swizzle


def test_int4_wrapper_argtypes_match_the_c_entry():
    """The ctypes argument list of B7's entry (pointers, ints, stream)
    matches its ``extern "C"`` signature, type for type."""
    from llmrankers_tpu_torch.ops import int4_matmul

    src = _source("int4_w4a8.cu")
    sig = src.split('extern "C" int quantized_matmul_int4_bf16(')[1].split(")")[0]
    params = [" ".join(p.split()) for p in sig.split(",")]
    want = [int4_matmul.ctypes.c_void_p if "*" in p else int4_matmul.ctypes.c_int
            for p in params]
    assert all("*" in p or p.startswith("int ") for p in params), params
    assert int4_matmul.ENTRY == want


def test_build_key_follows_the_shared_header(tmp_path, monkeypatch):
    """A change to a header the sources include rebuilds them."""
    for name in os.listdir(_build.CSRC_DIR):
        (tmp_path / name).write_bytes(open(os.path.join(_build.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    key = _build._digest()
    (tmp_path / "int8_quantize.cuh").write_text("// changed\n")
    assert _build._digest() != key


def test_load_all_builds_each_source_and_raises(fresh_build, monkeypatch):
    """load_all starts one nvcc per source and raises a failed build."""
    log = fresh_build / "calls"
    fake = fresh_build / "nvcc"
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\necho 'error: no GPU' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no GPU"):
        _build.load_all(["flash_blhd", "int8_fusedq"])
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert {c.split()[-1].rsplit("/", 1)[1] for c in calls} == {
        "flash_blhd.cu", "int8_fusedq.cu"}


def test_flash_source_serves_the_three_layouts():
    """One hand-written flash source serves B1, B2 and B5: one C entry with
    batch, head and row strides per tensor (turned into TMA tensor maps), a
    GQA group and a window; both products on wgmma (P from registers, V
    read MN-major), loads by TMA through an mbarrier ring fed by a producer
    warpgroup, and no mma.sync left."""
    with open(os.path.join(_build.CSRC_DIR, "flash_blhd.cu")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC_DIR, "wgmma_bf16.cuh")) as f:
        mma = f.read()
    assert 'extern "C" int flash_attn_bf16(' in src
    assert src.count("__global__") == 1  # one kernel for every layout
    assert '#include "tma_encode.cuh"' in src  # the encoder lookup, shared with B3
    src += _source("tma_encode.cuh")
    for field in ("int group;", "int window;", "h / p.group", "o_hs",
                  "2ull * st[1]", "2ull * st[4]", "2ull * st[7]"):  # q, k, v head strides
        assert field in src
    for ptx in ("cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                "mbarrier.arrive.expect_tx", "setmaxnreg.dec", "setmaxnreg.inc",
                "wgmma.fence", "wgmma::ss<kBK>", "wgmma::rs<DH>",
                "cudaGetDriverEntryPoint", "cuTensorMapEncodeTiled"):
        assert ptx in src, ptx
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in mma
    # the register-A form with the B transpose flag set, for every Dh
    for n in range(16, 129, 16):
        assert f"m64n{n}k16.f32.bf16.bf16" in mma
    assert "p, 1, 1, 1;" in mma
    assert "mma.sync.aligned" not in src  # no Ampere-era tensor-core instruction
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
