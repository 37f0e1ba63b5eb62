"""One rank of a port CLI for tests/test_torch_parallel.py (not collected
by pytest): ``python tests/_torch_rank.py <cli> <args...>`` runs
``effi_mvs_plus_tpu_torch.cli.<cli>.main(args)`` in this process, which
the launcher gives torchrun's environment, with the metrics writer's
TensorBoard sink off (its import takes seconds; the JSONL is the
record)."""

import functools
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from effi_mvs_plus_tpu_torch.utils import logging as tlog  # noqa: E402

tlog.MetricsWriter.__init__ = functools.partialmethod(
    tlog.MetricsWriter.__init__, tensorboard=False)
importlib.import_module(
    f"effi_mvs_plus_tpu_torch.cli.{sys.argv[1]}").main(sys.argv[2:])
