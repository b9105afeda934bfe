"""Example compartmental models (counterpart of
``pyro_tpu/contrib/epidemiology/models.py``).

Every model is written against :func:`binomial_dist` and
:func:`infection_dist`; under relaxed inference the
:class:`CompartmentalModel` base switches those helpers to moment-matched
Normals over real flows, and under quantized inference their exact,
extended forms score the enumerated flows.  Data and constants are made
on the model's device when it is built.
"""

from __future__ import annotations

import torch

from ... import distributions as dist
from ... import poutine
from ... import primitives as pyro
from .compartmental import CompartmentalModel
from .distributions import binomial_dist, infection_dist


def _observed(model, t):
    """The data of step ``t`` (a slice: the whole series), or None past it."""
    return model.data[t] if isinstance(t, slice) or t < model.duration else None


class _DataModel(CompartmentalModel):
    """A model over one series of ``data`` (the duration)."""

    def __init__(self, compartments, population, data, **kwargs):
        super().__init__(compartments, len(data), population, **kwargs)
        self.data = torch.as_tensor(data, dtype=torch.get_default_dtype()).to(self.device)


class SimpleSIRModel(_DataModel):
    """SIR with binomial observations of new infections."""

    def __init__(self, population: int, recovery_time: float, data):
        super().__init__(["S", "I"], population, data)
        assert recovery_time > 1
        self.recovery_time = recovery_time

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, tau, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, tau, rho = params
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=R0 / tau, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population),
        )
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R}
        pyro.sample(f"obs_{t}", binomial_dist(S2I, rho), obs=_observed(self, t))
        return new_state

    def compute_flows(self, prev, curr, t):
        S2I = prev["S"] - curr["S"]
        I2R = prev["I"] - curr["I"] + S2I
        return {f"S2I_{t}": S2I, f"I2R_{t}": I2R}


class SimpleSEIRModel(_DataModel):
    """SEIR with an incubation (Exposed) compartment."""

    def __init__(self, population: int, incubation_time: float, recovery_time: float, data):
        super().__init__(["S", "E", "I"], population, data)
        assert incubation_time > 1
        assert recovery_time > 1
        self.incubation_time = incubation_time
        self.recovery_time = recovery_time

    def global_model(self):
        tau_e = self.incubation_time
        tau_i = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, tau_e, tau_i, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "E": 0.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, tau_e, tau_i, rho = params
        S2E = pyro.sample(
            f"S2E_{t}",
            infection_dist(individual_rate=R0 / tau_i, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population),
        )
        E2I = pyro.sample(f"E2I_{t}", binomial_dist(state["E"], 1 / tau_e))
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau_i))
        new_state = {"S": state["S"] - S2E, "E": state["E"] + S2E - E2I, "I": state["I"] + E2I - I2R}
        pyro.sample(f"obs_{t}", binomial_dist(S2E, rho), obs=_observed(self, t))
        return new_state


class SimpleSEIRDModel(_DataModel):
    """SEIRD with a deceased compartment."""

    def __init__(self, population: int, incubation_time: float, recovery_time: float, mortality_rate: float,
                 data):
        super().__init__(["S", "E", "I", "D"], population, data)
        assert incubation_time > 1 and recovery_time > 1
        assert 0 < mortality_rate < 1
        self.incubation_time = incubation_time
        self.recovery_time = recovery_time
        self.mortality_rate = mortality_rate

    def global_model(self):
        tau_e = self.incubation_time
        tau_i = self.recovery_time
        mu = self.mortality_rate
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, tau_e, tau_i, mu, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "E": 0.0, "I": 1.0, "D": 0.0}

    def transition(self, params, state, t):
        R0, tau_e, tau_i, mu, rho = params
        S2E = pyro.sample(
            f"S2E_{t}",
            infection_dist(individual_rate=R0 / tau_i, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population),
        )
        E2I = pyro.sample(f"E2I_{t}", binomial_dist(state["E"], 1 / tau_e))
        I2D = pyro.sample(f"I2D_{t}", binomial_dist(state["I"], mu / tau_i))
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"] - I2D, 1 / tau_i))
        new_state = {
            "S": state["S"] - S2E,
            "E": state["E"] + S2E - E2I,
            "I": state["I"] + E2I - I2R - I2D,
            "D": state["D"] + I2D,
        }
        pyro.sample(f"obs_{t}", binomial_dist(S2E, rho), obs=_observed(self, t))
        return new_state


class OverdispersedSIRModel(_DataModel):
    """SIR with a learned global overdispersion."""

    def __init__(self, population: int, recovery_time: float, data):
        super().__init__(["S", "I"], population, data)
        assert recovery_time > 1
        self.recovery_time = recovery_time

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        od = pyro.sample("od", dist.Beta(2.0, 6.0))
        return R0, tau, rho, od

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, tau, rho, od = params
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=R0 / tau, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population, overdispersion=od),
        )
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau, overdispersion=od))
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R}
        pyro.sample(f"obs_{t}", binomial_dist(S2I, rho, overdispersion=od), obs=_observed(self, t))
        return new_state


class OverdispersedSEIRModel(_DataModel):
    """SEIR with a learned global overdispersion."""

    def __init__(self, population: int, incubation_time: float, recovery_time: float, data):
        super().__init__(["S", "E", "I"], population, data)
        assert incubation_time > 1 and recovery_time > 1
        self.incubation_time = incubation_time
        self.recovery_time = recovery_time

    def global_model(self):
        tau_e = self.incubation_time
        tau_i = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        od = pyro.sample("od", dist.Beta(2.0, 6.0))
        return R0, tau_e, tau_i, rho, od

    def initialize(self, params):
        return {"S": self.population - 1.0, "E": 0.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, tau_e, tau_i, rho, od = params
        S2E = pyro.sample(
            f"S2E_{t}",
            infection_dist(individual_rate=R0 / tau_i, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population, overdispersion=od),
        )
        E2I = pyro.sample(f"E2I_{t}", binomial_dist(state["E"], 1 / tau_e, overdispersion=od))
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau_i, overdispersion=od))
        new_state = {"S": state["S"] - S2E, "E": state["E"] + S2E - E2I, "I": state["I"] + E2I - I2R}
        pyro.sample(f"obs_{t}", binomial_dist(S2E, rho, overdispersion=od), obs=_observed(self, t))
        return new_state


class SuperspreadingSIRModel(_DataModel):
    """SIR with superspreading: each infectious individual infects
    BetaBinomial-many susceptibles, with dispersion ``k`` (Lloyd-Smith et
    al. 2005)."""

    def __init__(self, population: int, recovery_time: float, data):
        super().__init__(["S", "I"], population, data)
        assert recovery_time > 1
        self.recovery_time = recovery_time

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        k = pyro.sample("k", dist.Exponential(1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, k, tau, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, k, tau, rho = params
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=R0, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population, concentration=k),
        )
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R}
        pyro.sample(f"obs_{t}", binomial_dist(S2I, rho), obs=_observed(self, t))
        return new_state


def _steps(value, n):
    """``value`` repeated along a new last dim of size ``n``."""
    return value[..., None].expand(value.shape + (n,))


class HeterogeneousSIRModel(_DataModel):
    """SIR with a time-varying Rt (log-Brownian drift) and a piecewise
    response rate."""

    def __init__(self, population: int, recovery_time: float, data):
        super().__init__(["S", "I"], population, data)
        assert recovery_time > 1
        self.recovery_time = recovery_time

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho0 = pyro.sample("rho0", dist.Beta(2.0, 4.0))
        rho1 = pyro.sample("rho1", dist.Beta(4.0, 4.0))
        rho2 = pyro.sample("rho2", dist.Beta(8.0, 4.0))
        d = self.duration
        n0 = min(14, d)
        n1 = min(7, max(d - n0, 0))
        n2 = max(d - n0 - n1, 0)
        rho = torch.cat([_steps(rho0, n0), _steps(rho1, n1), _steps(rho2, n2)], dim=-1)
        pyro.deterministic("rho", rho, event_dim=1)
        return R0, tau, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": 1.0, "beta": 1.0}

    def transition(self, params, state, t):
        R0, tau, rho = params
        beta = pyro.sample(f"beta_{t}", dist.LogNormal(torch.log(state["beta"].clamp(min=1e-6)), 0.1))
        Rt = pyro.deterministic(f"Rt_{t}", R0 * beta)
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=Rt / tau, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population),
        )
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R, "beta": beta}
        rho_t = rho[..., min(t, rho.shape[-1] - 1) if isinstance(t, int) else t]
        pyro.sample(f"obs_{t}", binomial_dist(S2I, rho_t), obs=_observed(self, t))
        return new_state


def _coupled(model, state):
    """Infectious counts coupled across regions: the cross-region terms
    take the non-enumerated proxy ``I_approx``, the region's own term the
    exact (perhaps enumerated) count."""
    I_approx = state.get("I_approx", state["I"])
    I_coupled = I_approx @ model.coupling + (state["I"] - I_approx) * torch.diagonal(model.coupling)
    return I_coupled.clamp(min=0.0), model._pop @ model.coupling


class _RegionalModel(CompartmentalModel):
    """S and I over regions coupled by a matrix; I approximated across
    regions."""

    def __init__(self, population, coupling, recovery_time: float, data):
        dtype = torch.get_default_dtype()
        population = torch.as_tensor(population, dtype=dtype)
        coupling = torch.as_tensor(coupling, dtype=dtype)
        num_regions = population.shape[0]
        assert coupling.shape == (num_regions, num_regions)
        assert recovery_time > 1
        super().__init__(["S", "I"], len(data), population, approximate=("I",))
        self.population = self._pop
        self.coupling = coupling.to(self.device)
        self.recovery_time = recovery_time
        self.num_regions = num_regions
        self.data = torch.as_tensor(data, dtype=dtype).to(self.device)


class RegionalSIRModel(_RegionalModel):
    """SIR over coupled regions: infections mix across regions through a
    coupling matrix.  The region dim is a plate."""

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        with self.region_plate:
            rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, tau, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": torch.ones_like(self.population)}

    def transition(self, params, state, t):
        R0, tau, rho = params
        I_coupled, pop_coupled = _coupled(self, state)
        with self.region_plate:
            S2I = pyro.sample(
                f"S2I_{t}",
                infection_dist(individual_rate=R0 / tau, num_susceptible=state["S"], num_infectious=I_coupled,
                               population=pop_coupled),
            )
            I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
            pyro.sample(f"obs_{t}", binomial_dist(S2I, rho), obs=_observed(self, t))
        return {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R}

    def compute_flows(self, prev, curr, t):
        S2I = prev["S"] - curr["S"]
        I2R = prev["I"] - curr["I"] + S2I
        return {f"S2I_{t}": S2I, f"I2R_{t}": I2R}


class SparseSIRModel(_DataModel):
    """SIR with sparse observations of cumulative infections, through an
    observed-count compartment ``O``.  The observation is a tight
    Normal(O, 0.5), so relaxed inference can score it."""

    def __init__(self, population: int, recovery_time: float, data, mask):
        assert len(data) == len(mask)
        super().__init__(["S", "I", "O"], population, data)
        assert recovery_time > 1
        self.recovery_time = recovery_time
        self.mask = torch.as_tensor(mask, dtype=torch.bool).to(self.device)

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, tau, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "I": 1.0, "O": 0.0}

    def transition(self, params, state, t):
        R0, tau, rho = params
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=R0 / tau, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population),
        )
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
        S2O = pyro.sample(f"S2O_{t}", binomial_dist(S2I, rho))
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R, "O": state["O"] + S2O}
        mask_t = self.mask[t] if isinstance(t, slice) or t < self.duration else False
        with poutine.mask(mask=mask_t):
            pyro.sample(f"obs_{t}", dist.Normal(new_state["O"], 0.5), obs=_observed(self, t))
        return new_state

    def compute_flows(self, prev, curr, t):
        S2I = prev["S"] - curr["S"]
        I2R = prev["I"] - curr["I"] + S2I
        S2O = curr["O"] - prev["O"]
        return {f"S2I_{t}": S2I, f"I2R_{t}": I2R, f"S2O_{t}": S2O}


class UnknownStartSIRModel(CompartmentalModel):
    """SIR with an unknown date of first infection: a window before the
    observations with a constant external infection rate and a lower
    response rate."""

    def __init__(self, population: int, recovery_time: float, pre_obs_window: int, data):
        assert recovery_time > 1
        assert isinstance(pre_obs_window, int) and pre_obs_window > 0
        super().__init__(["S", "I"], pre_obs_window + len(data), population)
        self.recovery_time = recovery_time
        self.pre_obs_window = pre_obs_window
        self.post_obs_window = len(data)
        # on average one external infection during the pre-window
        self.external_rate = 1.0 / pre_obs_window
        data = torch.as_tensor(data, dtype=torch.get_default_dtype()).to(self.device)
        self.data = torch.cat([data.new_zeros(pre_obs_window), data])

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        rho0 = pyro.sample("rho0", dist.Beta(10.0, 10.0))
        rho1 = pyro.sample("rho1", dist.Beta(10.0, 10.0))
        rho = torch.cat([_steps(rho0, self.pre_obs_window), _steps(rho1, self.post_obs_window)], dim=-1)
        # external infections as an infectious pseudo-individual
        X = self.external_rate * tau / R0
        return R0, X, tau, rho

    def initialize(self, params):
        return {"S": float(self.population), "I": 0.0}

    def transition(self, params, state, t):
        R0, X, tau, rho = params
        S2I = pyro.sample(
            f"S2I_{t}",
            infection_dist(individual_rate=R0 / tau, num_susceptible=state["S"], num_infectious=state["I"] + X,
                           population=self.population),
        )
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
        new_state = {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R}
        rho_t = rho[..., min(t, rho.shape[-1] - 1) if isinstance(t, int) else t]
        pyro.sample(f"obs_{t}", binomial_dist(S2I, rho_t), obs=_observed(self, t))
        return new_state


class SuperspreadingSEIRModel(_DataModel):
    """SEIR with superspreading.  The JAX package's optional phylogenetic
    likelihood over coalescent times (``leaf_times``, ``coal_times``) needs
    ``CoalescentRateLikelihood``, not ported yet (ROADMAP Queue 1 item 7,
    ``coalescent.py``): given those times, this raises."""

    def __init__(self, population: int, incubation_time: float, recovery_time: float, data, *, leaf_times=None,
                 coal_times=None):
        super().__init__(["S", "E", "I"], population, data)
        assert incubation_time > 1 and recovery_time > 1
        assert (leaf_times is None) == (coal_times is None)
        if leaf_times is not None:
            raise NotImplementedError(
                "SuperspreadingSEIRModel's phylogenetic likelihood needs CoalescentRateLikelihood "
                "(coalescent.py), not ported yet (ROADMAP Queue 1 item 7)"
            )
        self.incubation_time = incubation_time
        self.recovery_time = recovery_time
        self.coal_likelihood = None

    def global_model(self):
        tau_e = self.incubation_time
        tau_i = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        k = pyro.sample("k", dist.Exponential(1.0))
        rho = pyro.sample("rho", dist.Beta(10.0, 10.0))
        return R0, k, tau_e, tau_i, rho

    def initialize(self, params):
        return {"S": self.population - 1.0, "E": 0.0, "I": 1.0}

    def transition(self, params, state, t):
        R0, k, tau_e, tau_i, rho = params
        E2I = pyro.sample(f"E2I_{t}", binomial_dist(state["E"], 1 / tau_e))
        I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau_i))
        S2E = pyro.sample(
            f"S2E_{t}",
            infection_dist(individual_rate=R0, num_susceptible=state["S"], num_infectious=state["I"],
                           population=self.population, concentration=k),
        )
        pyro.sample(f"obs_{t}", binomial_dist(S2E, rho), obs=_observed(self, t))
        return {"S": state["S"] - S2E, "E": state["E"] + S2E - E2I, "I": state["I"] + E2I - I2R}


class HeterogeneousRegionalSIRModel(_RegionalModel):
    """Regional SIR with a time-varying Rt shared by the regions and a
    response rate varying by time and region, both drifting as transformed
    Brownian motion with learned drift rates."""

    def __init__(self, population, coupling, recovery_time: float, data):
        super().__init__(population, coupling, recovery_time, data)
        self._I0 = torch.zeros(self.num_regions, dtype=self._pop.dtype, device=self.device)
        self._I0[0] = 1.0

    def global_model(self):
        tau = self.recovery_time
        R0 = pyro.sample("R0", dist.LogNormal(0.0, 1.0))
        R_drift = pyro.sample("R_drift", dist.LogNormal(-3.0, 1.0))
        with self.region_plate:
            rho0 = pyro.sample("rho0", dist.Beta(4.0, 4.0))
        rho_drift = pyro.sample("rho_drift", dist.LogNormal(-3.0, 1.0))
        return tau, R0, R_drift, rho0, rho_drift

    def initialize(self, params):
        return {
            "S": self.population - self._I0,
            "I": self._I0,
            "R_factor": 1.0,
            "rho_shift": torch.zeros_like(self._I0),
        }

    def transition(self, params, state, t):
        tau, R0, R_drift, rho0, rho_drift = params
        I_coupled, pop_coupled = _coupled(self, state)
        R_factor = pyro.sample(
            f"R_factor_{t}", dist.LogNormal(torch.log(state["R_factor"].clamp(min=1e-6)), R_drift)
        )
        Rt = pyro.deterministic(f"Rt_{t}", R0 * R_factor)
        with self.region_plate:
            rho_shift = pyro.sample(f"rho_shift_{t}", dist.Normal(state["rho_shift"], rho_drift))
            # event_dim=0: the region dim is the plate's batch dim
            rho = pyro.deterministic(
                f"rho_{t}", torch.sigmoid(torch.log(rho0) - torch.log1p(-rho0) + rho_shift), event_dim=0
            )
            S2I = pyro.sample(
                f"S2I_{t}",
                infection_dist(individual_rate=Rt / tau, num_susceptible=state["S"], num_infectious=I_coupled,
                               population=pop_coupled),
            )
            I2R = pyro.sample(f"I2R_{t}", binomial_dist(state["I"], 1 / tau))
            pyro.sample(f"obs_{t}", binomial_dist(S2I, rho), obs=_observed(self, t))
        return {"S": state["S"] - S2I, "I": state["I"] + S2I - I2R, "R_factor": R_factor, "rho_shift": rho_shift}
