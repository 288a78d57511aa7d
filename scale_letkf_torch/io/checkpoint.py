"""Restart checkpointing: one npz file per member plus manifest.json.

Port of scale_letkf_tpu/io/checkpoint.py, in the same format, so a
directory written by either package loads in the other: member files
`<basename with @@@@ → 0001…>.npz` holding rho, rhou, rhov, rhow, rhot and
rhoq; the deterministic member under the 'mdet' name; auxiliary fields as
`<name>.npz` with key `data`; history snapshots as `hist.@@@@.npz` with
`hist.json`. Tensors are written from any device; loading returns numpy
arrays (io/convert.py puts them on a device).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from scale_letkf_torch.model.dycore import DycoreState

_FIELDS = DycoreState._fields


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def filename_replace_mem(template: str, member: int | str) -> str:
    """'@@@@' or '<member>' → the zero-padded member number, or the special
    member name 'mean' / 'mdet' (common_nml.f90:1038-1080)."""
    rep = member if isinstance(member, str) else f"{member + 1:04d}"
    return template.replace("<member>", rep).replace("@@@@", rep)


def save_member(path: str | Path, s: DycoreState):
    np.savez(path, **{k: _host(v) for k, v in zip(_FIELDS, s)})


def load_member(path: str | Path) -> DycoreState:
    z = np.load(path)
    return DycoreState(*(z[k] for k in _FIELDS))


def save_ensemble(dirpath: str | Path, ens: DycoreState,
                  basename: str = "anal.@@@@",
                  aux: dict | None = None, meta: dict | None = None,
                  det: DycoreState | None = None):
    """One member file per ensemble member (K leading on every field),
    manifest and aux fields; `det`, the deterministic member (DET_RUN), under
    the 'mdet' member name."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    K = ens.rho.shape[0]
    names = []
    for m in range(K):
        fname = filename_replace_mem(basename, m) + ".npz"
        save_member(d / fname, DycoreState(*(f[m] for f in ens)))
        names.append(fname)
    if det is not None:
        save_member(d / (filename_replace_mem(basename, "mdet") + ".npz"),
                    det)
    for k, v in (aux or {}).items():
        np.savez(d / f"{k}.npz", data=_host(v))
    manifest = {"members": K, "basename": basename, "files": names,
                "det": det is not None, "aux": sorted(aux) if aux else [],
                "meta": meta or {}}
    (d / "manifest.json").write_text(json.dumps(manifest, indent=1))


def manifest_members(dirpath: str | Path) -> int:
    """The member count a checkpoint's manifest records."""
    return int(json.loads((Path(dirpath) / "manifest.json").read_text())
               ["members"])


def load_ensemble(dirpath: str | Path, basename: str | None = None,
                  members: list[int] | None = None
                  ) -> tuple[DycoreState, dict[str, np.ndarray], dict]:
    """(state of numpy arrays, K leading; aux fields; meta). members: the
    member indices to read (all when None), in that order."""
    d = Path(dirpath)
    manifest = json.loads((d / "manifest.json").read_text())
    basename = basename or manifest["basename"]
    if members is None:
        members = range(manifest["members"])
    states = [load_member(d / (filename_replace_mem(basename, m) + ".npz"))
              for m in members]
    ens = DycoreState(*(np.stack(f) for f in zip(*states)))
    aux = {k: np.load(d / f"{k}.npz")["data"]
           for k in manifest.get("aux", [])}
    return ens, aux, manifest.get("meta", {})


def load_det(dirpath: str | Path) -> DycoreState | None:
    """The deterministic member of a checkpoint, or None."""
    d = Path(dirpath)
    manifest = json.loads((d / "manifest.json").read_text())
    if not manifest.get("det"):
        return None
    return load_member(
        d / (filename_replace_mem(manifest["basename"], "mdet") + ".npz"))


def save_history(dirpath: str | Path, hist, basename: str = "hist.@@@@",
                 slot_ids: list[int] | None = None):
    """Per-slot history snapshots for the 4-D observation operator: hist
    (K, S, NV3D, nz, ny, nx), one file per member."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    hist = _host(hist)
    K = hist.shape[0]
    for m in range(K):
        np.savez(d / (filename_replace_mem(basename, m) + ".npz"),
                 hist=hist[m])
    (d / "hist.json").write_text(json.dumps({
        "members": K, "slots": int(hist.shape[1]), "basename": basename,
        "slot_ids": slot_ids or list(range(1, hist.shape[1] + 1))}))


def load_history(dirpath: str | Path) -> np.ndarray | None:
    """The per-slot history snapshots of save_history, (K, S, NV3D, nz, ny,
    nx) numpy; None when the checkpoint has none."""
    d = Path(dirpath)
    if not (d / "hist.json").exists():
        return None
    meta = json.loads((d / "hist.json").read_text())
    return np.stack([
        np.load(d / (filename_replace_mem(meta["basename"], m) + ".npz"))
        ["hist"] for m in range(meta["members"])])
