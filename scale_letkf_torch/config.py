"""Runtime configuration of the port: its own copy of
scale_letkf_tpu/config.py, field for field, so both packages load an
experiment TOML to the same values (tests/test_torch_config.py holds them
equal). The fields that name TPU knobs (eigh_impl, hdxb_gather_bf16,
level_batch, the mesh) are kept so a TOML written for either package loads
in both.

Mirrors the reference namelist config surface (reference:
scale/common/common_nml.f90:40-345 — PARAM_ENSEMBLE, PARAM_MODEL,
PARAM_PROCESS, PARAM_LOG, PARAM_OBSOPE, PARAM_LETKF, PARAM_LETKF_OBS,
PARAM_LETKF_VAR_LOCAL, PARAM_LETKF_MONITOR, PARAM_LETKF_RADAR,
PARAM_OBS_ERROR, PARAM_OBSSIM) as typed dataclasses, loadable from TOML.

Design difference from the reference: one structured config object passed
explicitly through the pipeline instead of module-global namelist state;
all defaults match the reference defaults so a reference user's settings
translate one-to-one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

NOBTYPE = 24   # number of observation report types (common_obs_scale.f90:86-91)
NID_OBS = 16   # number of observation variable ids (common_nml.f90:21)


def _pernobtype(first: float, rest: float | None = None) -> list[float]:
    """Reference per-obtype arrays use entry 1 as default; negatives inherit it."""
    r = first if rest is None else rest
    return [first] + [r] * (NOBTYPE - 1)


@dataclass
class EnsembleConfig:
    """PARAM_ENSEMBLE (common_nml.f90:39-47)."""
    member: int = 3
    det_run: bool = False
    det_run_cycled: bool = True


@dataclass
class ProcessConfig:
    """PARAM_PROCESS analogue: the device-mesh layout.

    The reference maps members onto MPI ranks/nodes (PPN, MEM_NODES,
    common_nml.f90:54-61, common_mpi_scale.f90:367). TPU-natively this
    becomes the shape of the jax device mesh: (member, dom_y, dom_x).
    """
    mesh_member: int = 1   # devices along the ensemble axis
    mesh_y: int = 1        # devices along domain y
    mesh_x: int = 1        # devices along domain x


@dataclass
class LogConfig:
    """PARAM_LOG (common_nml.f90:64-69)."""
    log_level: int = 2
    use_timer_barrier: bool = True   # USE_MPI_BARRIER analogue: block_until_ready between timed sections


@dataclass
class ObsOpeConfig:
    """PARAM_OBSOPE (common_nml.f90:74-92): 4-D window slots + obs inputs."""
    obs_in_name: tuple[str, ...] = ("obs.dat",)
    obs_in_format: tuple[str, ...] = ("PREPBUFR",)
    obsda_out: bool = False
    obsda_out_basename: str = "obsda.@@@@"
    slot_start: int = 1
    slot_end: int = 1
    slot_base: int = 1
    slot_tinterval: float = 3600.0


@dataclass
class LetkfConfig:
    """PARAM_LETKF (common_nml.f90:94-155)."""
    # multiplicative inflation
    infl_mul: float = 1.0            # >0 constant; <=0 use 3-D field
    infl_mul_min: float = -1.0
    infl_mul_adaptive: bool = False
    # additive inflation
    infl_add: float = 0.0
    infl_add_in_basename: str = "addi.@@@@"  # INFL_ADD_IN_BASENAME (common_nml.f90:117)
    infl_add_shuffle: bool = False
    infl_add_q_ratio: bool = False
    infl_add_ref_only: bool = False
    # relaxation
    relax_alpha: float = 0.0         # RTPP (Zhang et al. 2004)
    relax_alpha_spread: float = 0.0  # RTPS (Whitaker & Hamill 2012)
    relax_to_inflated_prior: bool = False
    relax_spread_out: bool = False
    # gross error QC thresholds (in units of obs error stdev)
    gross_error: float = 5.0
    gross_error_rain: float = -1.0
    gross_error_radar_ref: float = -1.0
    gross_error_radar_vr: float = -1.0
    gross_error_h08: float = -1.0
    # humidity handling
    q_update_top: float = 0.0        # Pa; q updated only below this level (0: everywhere)
    q_sprd_max: float = -1.0         # max spread/mean ratio for q (<=0: off)
    positive_definite_q: bool = False
    positive_definite_qhyd: bool = False
    # lateral-boundary analysis damping
    boundary_buffer_width: float = 0.0   # m
    ps_adjust_thres: float = 100.0
    nobs_out: bool = False
    # eigensolver backend for the batched K×K transform (framework knob, no
    # reference analogue): 'lax' = jnp.linalg.eigh; 'jacobi' = MXU-native
    # parallel Jacobi (ops/eigh_jacobi.py), faster at large K on TPU
    eigh_impl: str = "auto"
    # bf16-packed (dep|hdxb) obs-table gather in the analysis (halves the
    # element-count-bound TPU gather; hdxb carries ~0.4% of the H(x)
    # perturbation magnitude — same precision class as the bf16 state
    # transport). Set False for strict-f32 selection parity.
    hdxb_gather_bf16: bool = True
    # levels batched per analysis scan iteration; 0 = auto (batch small
    # domains up to ~64k gridpoints per iteration, chunk 1 at full size) —
    # framework knob, no reference analogue (the reference loop is scalar)
    level_batch: int = 0

    def gross_thresh(self, kind: str) -> float:
        v = {
            "rain": self.gross_error_rain,
            "radar_ref": self.gross_error_radar_ref,
            "radar_vr": self.gross_error_radar_vr,
            "h08": self.gross_error_h08,
        }.get(kind, -1.0)
        return v if v > 0 else self.gross_error


@dataclass
class LetkfObsConfig:
    """PARAM_LETKF_OBS (common_nml.f90:158-225): per-obtype localization."""
    use_obs: tuple[bool, ...] = tuple([True] * NOBTYPE)
    hori_local: tuple[float, ...] = tuple(_pernobtype(500.0e3, -1.0))
    vert_local: tuple[float, ...] = tuple(
        [0.4] + [-1.0] * 20 + [1000.0, -1.0, -1.0]
    )
    time_local: tuple[float, ...] = tuple(_pernobtype(0.0, -1.0))
    hori_local_radar_obsnoref: float = -1.0
    hori_local_radar_vr: float = -1.0
    vert_local_radar_vr: float = -1.0
    vert_local_rain_base: float = 85000.0
    max_nobs_per_grid: tuple[int, ...] = tuple([0] + [-1] * (NOBTYPE - 1))
    max_nobs_per_grid_criterion: int = 1
    # HBM-capacity bound on the obs bucket tables (framework knob; plays
    # the role of the reference's incremental-radius search bound,
    # letkf_tools.f90:1479): per-cell capacity cap. 0 = auto (2× the
    # per-gridpoint obs limit when one is set, else unbounded); overflowing
    # cells are stratified-thinned.
    max_bucket_capacity: int = 0
    obs_min_spacing: tuple[float, ...] = (
        300.0e3, 100.0e3, 100.0e3, 150.0e3, 300.0e3, 150.0e3, 150.0e3, 100.0e3,
        150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3,
        300.0e3, 150.0e3, 150.0e3, 150.0e3, 150.0e3, 1.0e3, 15.0e3, 1000.0e3,
    )
    obs_sort_grid_spacing: tuple[float, ...] = tuple(_pernobtype(0.0, -1.0))

    def _resolve(self, arr: Sequence[float], typ: int) -> float:
        v = arr[typ]
        return arr[0] if v < 0 else v

    def hori_local_for(self, typ: int) -> float:
        """Effective horizontal localization scale (m) for report type typ (0-based)."""
        return self._resolve(self.hori_local, typ)

    def vert_local_for(self, typ: int) -> float:
        return self._resolve(self.vert_local, typ)

    def max_nobs_for(self, typ: int) -> int:
        v = self.max_nobs_per_grid[typ]
        return self.max_nobs_per_grid[0] if v < 0 else v


@dataclass
class VarLocalConfig:
    """PARAM_LETKF_VAR_LOCAL (common_nml.f90:227-236): variable localization
    weights per (obs var group -> state variable). 9 groups as in
    uid_obs_varlocal (common_obs_scale.f90:216)."""
    uv: tuple[float, ...] | None = None
    t: tuple[float, ...] | None = None
    q: tuple[float, ...] | None = None
    ps: tuple[float, ...] | None = None
    rain: tuple[float, ...] | None = None
    tc: tuple[float, ...] | None = None
    radar_ref: tuple[float, ...] | None = None
    radar_vr: tuple[float, ...] | None = None
    h08: tuple[float, ...] | None = None

    def table(self, nvar: int) -> np.ndarray:
        """(9, nvar) variable-localization factor table; default all ones."""
        rows = []
        for name in ("uv", "t", "q", "ps", "rain", "tc", "radar_ref",
                     "radar_vr", "h08"):
            v = getattr(self, name)
            rows.append(np.ones(nvar) if v is None else np.asarray(v, float))
        return np.stack(rows)


@dataclass
class MonitorConfig:
    """PARAM_LETKF_MONITOR (common_nml.f90:238-252)."""
    departure_stat: bool = True
    departure_stat_radar: bool = False
    departure_stat_t_range: float = 0.0
    obsdep_out: bool = True
    obsdep_out_basename: str = "obsdep"


@dataclass
class RadarConfig:
    """PARAM_LETKF_RADAR (common_nml.f90:255-287)."""
    use_radar_ref: bool = True
    use_radar_vr: bool = True
    use_obserr_radar_ref: bool = False
    use_obserr_radar_vr: bool = False
    radar_ref_thres_dbz: float = 15.0
    min_radar_ref_member: int = 1
    min_radar_ref_member_obsref: int = 1
    min_radar_ref_dbz: float = 0.0
    low_ref_shift: float = 0.0
    radar_zmax: float = 99.0e3
    method_ref_calc: int = 3
    use_terminal_velocity: bool = False

    @property
    def min_radar_ref(self) -> float:
        return 10.0 ** (0.1 * self.min_radar_ref_dbz)

    @property
    def radar_ref_thres(self) -> float:
        return 10.0 ** (0.1 * self.radar_ref_thres_dbz)


@dataclass
class H08Config:
    """PARAM_LETKF_H08 (common_nml.f90:277-289): Himawari-8 IR radiances."""
    h08_reject_land: bool = False
    h08_rttov_cld: bool = True         # all-sky (vs clear-sky) forward model
    h08_min_cld_member: int = 1
    h08_cldsky_thrs: float = -5.0      # <0: all members diagnosed cloudy
    h08_limit_lev: float = 20000.0     # Pa; reject obs sensitive above this
    h08_bt_min: float = 0.0            # K; reject colder obs
    h08_ch_use: tuple[int, ...] = (0, 0, 1, 0, 0, 0, 0, 0, 0, 0)


@dataclass
class ObsErrorConfig:
    """PARAM_OBS_ERROR (common_nml.f90:311-323): default obs error stdevs
    used by obsmake (synthetic obs) and optionally to override file errors."""
    u: float = 1.0
    v: float = 1.0
    t: float = 1.0
    q: float = 0.001
    rh: float = 10.0
    ps: float = 100.0
    radar_ref: float = 5.0
    radar_vr: float = 3.0
    tcx: float = 50.0e3
    tcy: float = 50.0e3
    tcp: float = 5.0e2
    # per-channel H08 BT errors (OBSERR_H08, common_nml.f90:309)
    h08: tuple[float, ...] = tuple([5.0] * 10)


@dataclass
class Config:
    """Top-level config: the single object the whole pipeline consumes."""
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    process: ProcessConfig = field(default_factory=ProcessConfig)
    log: LogConfig = field(default_factory=LogConfig)
    obsope: ObsOpeConfig = field(default_factory=ObsOpeConfig)
    letkf: LetkfConfig = field(default_factory=LetkfConfig)
    letkf_obs: LetkfObsConfig = field(default_factory=LetkfObsConfig)
    var_local: VarLocalConfig = field(default_factory=VarLocalConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    radar: RadarConfig = field(default_factory=RadarConfig)
    h08: H08Config = field(default_factory=H08Config)
    obs_error: ObsErrorConfig = field(default_factory=ObsErrorConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                sub = d[f.name]
                subcls = f.default_factory  # type: ignore[misc]
                if isinstance(sub, dict):
                    known = {x.name for x in dataclasses.fields(subcls)}
                    extra = set(sub) - known
                    if extra:
                        raise ValueError(f"unknown keys in [{f.name}]: {sorted(extra)}")
                    sub = {k: tuple(v) if isinstance(v, list) else v
                           for k, v in sub.items()}
                    kw[f.name] = subcls(**sub)
                else:
                    kw[f.name] = sub
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)}")
        return cls(**kw)

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        import tomllib
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))
