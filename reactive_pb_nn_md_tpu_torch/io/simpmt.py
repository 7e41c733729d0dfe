"""Simulation-parameter (.pmt) file parser.

Same key/value contract as the reference
(read_simulation_parameters.f90:24-275): a 'Simulation Methodology' section
with string-valued keys followed by a 'Simulation Parameters' section with
numeric keys.  Required keys, defaults and consistency checks mirror the
reference; compile-time switches of the reference (ms_evb_simulation,
verlet_allpairs, print_ms_evb_data, glob_v.f90:43-46) are promoted to
runtime keys here.
"""

from dataclasses import dataclass, field


@dataclass
class SimConfig:
    # methodology (strings)
    ensemble: str = None                 # NVE | NVT | NPT
    lj_comb_rule: str = None             # opls | standard
    ms_evb_simulation: bool = False      # runtime switch (was compile-time)
    print_ms_evb_data: bool = True
    verlet_allpairs: bool = False

    # numeric parameters
    n_step: int = None
    n_output: int = None
    n_exclusions: int = None
    checkpoint_velocity: int = 0         # cadence; 0 = off
    temperature: float = None
    initial_temp: float = None
    friction_coeff: float = 0.1
    pressure: float = None
    barofreq: int = 25
    baroscale: float = 0.01
    delta_t: float = None
    real_space_cutoff: float = None
    verlet_cutoff: float = None
    na_nslist: int = 0
    nb_nslist: int = 0
    nc_nslist: int = 0
    alpha_sqrt: float = 0.3
    pme_grid: int = 60
    spline_order: int = 6
    n_threads: int = 1                   # accepted for compatibility; unused
    debug: int = 0

    # extensions over the reference's keys
    precision: str = "fp32"              # fp32 | fp64 | mixed
    # Kahan-compensated x/v accumulation in the integrator: recovers most
    # of the fp64 integration accuracy at fp32 state + force cost (two
    # extra (N,3) carries; see md/integrators.two_sum_add).  Measured by
    # scripts/drift_study.py.
    compensated_sum: bool = False
    evb_max_states: int = 80
    # growth ceiling for the simulation loop's automatic evb_max_states
    # regrow on diabat overflow (the reference hard-stops at its
    # compile-time cap, ms_evb.f90:3107-3123; here the cap regrows like
    # neighbor capacity and only the ceiling aborts).  Defaults to
    # max(80, evb_max_states).
    evb_hard_max_states: int = None
    evb_max_chain: int = 3
    evb_max_neighbors: int = 10
    # small-tier cap for the two-tier per-state evaluation: the pipeline
    # runs at this cap and escalates to evb_max_states only on the rare
    # steps whose enumeration overflows it (exact physics,
    # ~2x cheaper at the reference's production cap of 80).
    # -1 = auto (48 when evb_max_states >= 64), 0 = off, > 0 explicit.
    evb_small_states: int = -1
    # hop-search geometry thresholds -- compile-time constants in the
    # reference (glob_v.f90:54-55), runtime keys here (Angstrom)
    evb_first_solvation_cutoff: float = 5.0
    evb_reactive_pair_distance: float = 2.5
    seed: int = 0
    # "eigh" = dense eigendecomposition of the padded H; "iterative" =
    # the JAX package's shift-and-invert Krylov ground state, a TPU
    # workaround for large caps: the port runs either deck with its one
    # ground state (ops/ground_state.py: kernel E on the card, eigh on
    # the CPU)
    eigensolver: str = "eigh"

    def validate(self):
        required = ["ensemble", "n_step", "n_output", "temperature",
                    "n_exclusions", "real_space_cutoff", "delta_t",
                    "verlet_cutoff", "lj_comb_rule"]
        for k in required:
            if getattr(self, k) is None:
                raise ValueError(f"required simulation parameter '{k}' "
                                 f"missing from simulation parameter file")
        if self.ensemble == "NPT" and self.pressure is None:
            raise ValueError("pressure required for NPT ensemble")
        if self.initial_temp is None:
            self.initial_temp = self.temperature
        if self.spline_order not in (4, 6):
            raise ValueError("spline_order must be 4 or 6")
        if self.eigensolver not in ("eigh", "iterative"):
            raise ValueError("eigensolver must be 'eigh' or 'iterative'")
        if self.evb_hard_max_states is None:
            self.evb_hard_max_states = max(80, self.evb_max_states)
        if self.evb_hard_max_states < self.evb_max_states:
            raise ValueError("evb_hard_max_states must be >= evb_max_states")
        if self.evb_reactive_pair_distance <= 0 \
                or self.evb_first_solvation_cutoff <= 0:
            raise ValueError("EVB hop-search cutoffs must be positive")
        if self.ms_evb_simulation and \
                self.evb_reactive_pair_distance > self.real_space_cutoff:
            # the short-cutoff reactive adjacency rides the neighbor list's
            # coverage guarantee (use cutoff + skin); a pair distance past
            # the real-space cutoff would silently miss hop candidates
            raise ValueError("evb_reactive_pair_distance must be <= "
                             "real_space_cutoff")
        return self


_STRING_KEYS = {
    "ensemble": "ensemble",
    "lj_comb_rule": "lj_comb_rule",
}
_BOOL_STRING_KEYS = {
    "ms_evb_simulation": "ms_evb_simulation",
    "print_ms_evb_data": "print_ms_evb_data",
    "verlet_allpairs": "verlet_allpairs",
    "compensated_sum": "compensated_sum",
}
_INT_KEYS = {"n_step", "n_output", "n_exclusions", "checkpoint_velocity",
             "barofreq", "na_nslist", "nb_nslist", "nc_nslist", "pme_grid",
             "spline_order", "n_threads", "debug", "evb_max_states",
             "evb_hard_max_states", "evb_max_chain", "evb_max_neighbors",
             "evb_small_states", "seed"}
_FLOAT_KEYS = {"temperature", "initial_temp", "friction_coeff", "pressure",
               "baroscale", "delta_t", "real_space_cutoff", "verlet_cutoff",
               "alpha_sqrt", "evb_first_solvation_cutoff",
               "evb_reactive_pair_distance"}
# section headers and other non-key lines that are part of the format
_IGNORED_FIRST_TOKENS = {"simulation"}


def read_sim_params(path) -> SimConfig:
    import warnings
    cfg = SimConfig()
    with open(path) as f:
        lines = f.read().splitlines()

    for line in lines:
        parts = line.split()
        if len(parts) < 2:
            continue
        key, val = parts[0], parts[1]
        if key in _STRING_KEYS:
            setattr(cfg, _STRING_KEYS[key], val)
        elif key in _BOOL_STRING_KEYS:
            setattr(cfg, _BOOL_STRING_KEYS[key],
                    val.lower() in ("yes", "true", "1"))
        elif key == "precision":
            cfg.precision = val
        elif key == "eigensolver":
            cfg.eigensolver = val
        elif key in _INT_KEYS:
            setattr(cfg, key, int(round(float(val))))
        elif key in _FLOAT_KEYS:
            setattr(cfg, key, float(val))
        elif key.lower() not in _IGNORED_FIRST_TOKENS:
            # a typo'd key silently running at its default is worse than
            # noise (the reference hard-stops only on MISSING keys;
            # read_simulation_parameters.f90:156-187)
            warnings.warn(f"unrecognized simulation parameter "
                          f"'{key}' ignored", stacklevel=2)

    return cfg.validate()
