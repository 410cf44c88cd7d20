"""Pure-NumPy golden SIFT oracle for testing (see reference.py); the
port's own copy of the JAX package's."""

from . import reference  # noqa: F401
