"""Entry drivers: one module per way of driving the program, each with a
``Driver`` class (see :mod:`benchmark.drivers.base`)."""
