"""Host-to-device copy time a batch (ms): the engine's upload of the
pageable batch (``infer/engine.py`` ``_to_device``)."""


def read(t):
    ms = t.memcpy_s("HtoD") * 1e3
    return ms or None
