"""Convolution kernels' device time a batch (ms): cuDNN and cuBLAS kernels
by name (the frozen ``CLASSES``)."""


def read(t):
    ms = t.class_s("convolution") * 1e3
    return ms or None
