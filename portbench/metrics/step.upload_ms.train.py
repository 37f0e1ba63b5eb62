"""Host-to-device copy time a step (ms): the train step's upload of the
pageable batch (``train/trainer.py`` ``batch_to_device``)."""


def read(t):
    ms = t.memcpy_s("HtoD") * 1e3
    return ms or None
