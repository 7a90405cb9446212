"""Builds both packages' native host libraries once, before any test worker
starts.

urh_tpu builds its library at first use straight to its cache path, so
xdist workers that start on a cold temp dir can load a file another
worker's g++ is still writing; a worker that fails to load it keeps the
library off for its whole life.  Building here, in the controller (or the
one process of a run without xdist), leaves the workers a whole file.

The packages are imported inside the hook: tests/conftest.py sets JAX's
flags before its own ``import jax``, and pytest imports this file first.
"""

import logging


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built them
    try:
        from urh_tpu.native import build as urh_tpu_build
        from urh_tpu_torch.native import build as urh_tpu_torch_build

        urh_tpu_build.build()
        urh_tpu_torch_build.build()
    except Exception as e:  # no g++, or no JAX: the tests meet it as before
        logging.getLogger(__name__).warning("native libraries not built ahead: %s", e)
