"""Stage-boundary checkpoint / resume on one process (port of `engine/checkpoint.py`).

The columnar state is persisted at pipeline stage boundaries with a
manifest that records the completed stages, and a rerun re-enters the
pipeline after the last one. The on-disk format is the JAX package's, so a
directory written by either package resumes in the other:

- ``manifest.json``: ``{"fingerprint": ..., "stages": {stage: {"ts": ...,
  "tables": {name: {"file", "kind", "names"}}}}}``, replaced atomically;
- one ``<stage>.<name>.npz`` per table, holding ``data`` (the whole buffer,
  padding included) and ``num_rows`` (0-d int32).

A manifest whose fingerprint differs from the config's counts as empty.
The multi-process pieces (a manifest broadcast from process 0, sharded
tables) wait for the port's multi-device path (ROADMAP, "Multi-device").
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from pim_sort_merge_join_tpu_torch.columnar.table import Table
from pim_sort_merge_join_tpu_torch.device import resolve_device

_MANIFEST = "manifest.json"


class StageCheckpointer:
    """Writes/reads per-stage table snapshots under a directory."""

    def __init__(self, directory: str, config_fingerprint: str = ""):
        self.directory = directory
        self.fingerprint = config_fingerprint
        os.makedirs(directory, exist_ok=True)

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, _MANIFEST)

    def _load_manifest(self) -> dict[str, Any]:
        empty = {"fingerprint": self.fingerprint, "stages": {}}
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return empty
        return m if m.get("fingerprint") == self.fingerprint else empty

    def _store_manifest(self, manifest: dict[str, Any]) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())  # atomic commit

    def save(self, stage: str, **tables: Table) -> None:
        """Persist named tables for a stage, then commit the manifest."""
        manifest = self._load_manifest()
        entry: dict[str, Any] = {"ts": time.time(), "tables": {}}
        for name, t in tables.items():
            path = os.path.join(self.directory, f"{stage}.{name}.npz")
            payload = _table_to_host(t)
            np.savez(path, **payload["arrays"])
            entry["tables"][name] = {
                "file": os.path.basename(path),
                "kind": payload["kind"],
                "names": payload["names"],
            }
        manifest["stages"][stage] = entry
        self._store_manifest(manifest)

    def completed_stages(self) -> list[str]:
        return list(self._load_manifest()["stages"].keys())

    def has(self, stage: str) -> bool:
        return stage in self.completed_stages()

    def load(self, stage: str) -> dict[str, Any]:
        """A stage's tables as host payloads: {name: {"kind", "arrays", "names"}}."""
        manifest = self._load_manifest()
        if stage not in manifest["stages"]:
            raise KeyError(f"no checkpoint for stage {stage!r}")
        out = {}
        for name, meta in manifest["stages"][stage]["tables"].items():
            with np.load(os.path.join(self.directory, meta["file"])) as z:
                arrays = {k: z[k] for k in z.files}
            out[name] = {"kind": meta["kind"], "arrays": arrays, "names": tuple(meta["names"])}
        return out

    def load_table(self, stage: str, name: str, device: str | torch.device | None = None) -> Table:
        """Restore a table from a checkpoint onto ``device`` (the card unless named)."""
        device = resolve_device(device)
        payload = self.load(stage)[name]
        if payload["kind"] != "table":
            raise TypeError(f"checkpoint {stage}.{name} is {payload['kind']!r}, not a table")
        arrays = payload["arrays"]
        return Table(
            data=torch.from_numpy(arrays["data"]).to(device),
            num_rows=torch.tensor(int(arrays["num_rows"]), dtype=torch.int32, device=device),
            names=payload["names"],
        )


def _table_to_host(t: Table) -> dict[str, Any]:
    if not isinstance(t, Table):
        raise TypeError(f"cannot checkpoint {type(t)!r}")
    return {
        "kind": "table",
        "names": list(t.names),
        "arrays": {"data": t.data.cpu().numpy(), "num_rows": t.num_rows.cpu().numpy()},
    }


def config_fingerprint(config) -> str:
    """Stable fingerprint of the parts of the config that affect state;
    equal to the JAX package's for a config with the same fields."""
    return json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
