"""The benchmark's yardstick: traffic, the closed loop, the trace reader,
the roofline arithmetic and the comparison that decides ``correct``. It
imports the measured program only in ``loop.py`` (the system under test)
and never ``jax`` or the JAX package."""
