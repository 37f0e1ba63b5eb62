"""Convolution kernels' device time a step (ms), forward and backward:
cuDNN and cuBLAS kernels by name (the frozen ``CLASSES``)."""


def read(t):
    ms = t.class_s("convolution") * 1e3
    return ms or None
