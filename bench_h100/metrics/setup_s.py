"""setup_s: seconds from the process's start to the window's: importing the
port, making the weights, building and warming the program (and on the
first run in a checkout, building its kernels)."""


def read(rec):
    return rec.setup_s
