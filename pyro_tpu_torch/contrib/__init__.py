"""Contributed models (counterpart of ``pyro_tpu/contrib``): so far the
``Parameterized`` base of ``contrib.gp`` and ``GenericLGSSM`` of
``contrib.timeseries``."""
