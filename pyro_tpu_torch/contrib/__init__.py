"""Contributed models (counterpart of ``pyro_tpu/contrib``): so far the
``Parameterized`` base of ``contrib.gp``, the state-space and GP models of
``contrib.timeseries``, ``contrib.forecast``, ``contrib.epidemiology`` and
the BART data set of ``contrib.examples``."""
