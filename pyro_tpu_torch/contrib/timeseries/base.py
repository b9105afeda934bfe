"""The time-series model base (counterpart of
``pyro_tpu/contrib/timeseries/base.py``)."""

from __future__ import annotations

from ..gp.parameterized import Parameterized


class TimeSeriesModel(Parameterized):
    """API: ``log_prob(targets)``, ``forecast(targets, dts)``."""

    def log_prob(self, targets):
        raise NotImplementedError

    def forecast(self, targets, dts):
        raise NotImplementedError

    def get_dist(self):
        raise NotImplementedError
