"""The modules that may not be loaded in a process that runs the program
or prints the result: JAX and the JAX package, compared by whole
top-level name (the port's name, ``kmergutsjava_tpu_torch``, begins with
the JAX package's)."""
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "kmergutsjava_tpu")


class ForbiddenModules(RuntimeError):
    """A process of the run loaded JAX or the JAX package."""


def loaded() -> List[str]:
    """The forbidden modules in this process's ``sys.modules``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
