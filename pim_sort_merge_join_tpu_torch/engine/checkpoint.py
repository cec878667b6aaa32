"""Stage-boundary checkpoint / resume (port of `engine/checkpoint.py`).

The columnar state is persisted at pipeline stage boundaries with a
manifest that records the completed stages, and a rerun re-enters the
pipeline after the last one. The on-disk format is the JAX package's, so a
directory written by either package resumes in the other:

- ``manifest.json``: ``{"fingerprint": ..., "stages": {stage: {"ts": ...,
  "tables": {name: {"file", "kind", "names"}}}}}``, replaced atomically;
- one ``<stage>.<name>.npz`` per table, holding ``data`` (the whole buffer,
  padding included) and ``num_rows`` (0-d int32).

A manifest whose fingerprint differs from the config's counts as empty.

Across the ranks of a process group (``group``, the multi-device
pipeline's): saving a sharded table is a collective that gathers every
rank's block into the reference's global view (``data [P * cap, ncol]``,
``counts [P]``, kind ``"sharded"``), and rank 0 alone writes the files and
the manifest; which stages are done is rank 0's view, broadcast, so every
rank takes the same resume decision. ``checkpoint_dir`` is storage that
rank 0 writes and every rank reads.
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
from pim_sort_merge_join_tpu_torch.exchange import collectives

_MANIFEST = "manifest.json"


class StageCheckpointer:
    """Writes/reads per-stage table snapshots under a directory."""

    def __init__(self, directory: str, config_fingerprint: str = "", group=None):
        """``group``: the process group whose ranks share the directory
        (None: this process alone)."""
        self.directory = directory
        self.fingerprint = config_fingerprint
        self.group = group
        os.makedirs(directory, exist_ok=True)

    def _rank(self) -> int:
        return 0 if self.group is None else collectives.rank(self.group)

    def _world(self) -> int:
        return 1 if self.group is None else collectives.world_size(self.group)

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

    def save(self, stage: str, **tables) -> None:
        """Persist named tables (`Table` or `ShardedTable`) for a stage, then
        commit the manifest.

        Across ranks every rank calls it with the same stage (gathering a
        sharded table is a collective); rank 0 writes, and every rank
        returns once the files are written.
        """
        write = self._rank() == 0
        manifest = self._load_manifest() if write else None
        entry: dict[str, Any] = {"ts": time.time(), "tables": {}}
        for name, t in tables.items():
            path = os.path.join(self.directory, f"{stage}.{name}.npz")
            payload = _table_to_host(t)  # a collective for sharded tables
            if write:
                np.savez(path, **payload["arrays"])
            entry["tables"][name] = {
                "file": os.path.basename(path),
                "kind": payload["kind"],
                "names": payload["names"],
            }
        if write:
            manifest["stages"][stage] = entry
            self._store_manifest(manifest)
        if self.group is not None:
            collectives.barrier(self.group)

    def completed_stages(self) -> list[str]:
        """Rank 0's view of the completed stages, on every rank (a
        collective across ranks): with storage that is not shared, or not
        coherent, ranks reading their own manifest could decide apart."""
        local = list(self._load_manifest()["stages"].keys())
        if self._world() == 1:
            return local
        return collectives.broadcast_object(local, self.group)

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


    def load_sharded(self, stage: str, name: str, device: str | torch.device | None = None):
        """This rank's block of a sharded table from a checkpoint, onto
        ``device`` (the card unless named), over the checkpointer's group.

        Blocks after the exchange are co-partitioned: rank i's rows join
        only rank i's, so the group must have the checkpoint's partition
        count (another P needs a fresh exchange).
        """
        from pim_sort_merge_join_tpu_torch.convert import sharded_from_reference

        payload = self.load(stage)[name]
        if payload["kind"] != "sharded":
            raise TypeError(f"checkpoint {stage}.{name} is not sharded")
        arrays = payload["arrays"]
        p = self._world()
        if arrays["counts"].shape[0] != p:
            raise ValueError(
                f"checkpoint has {arrays['counts'].shape[0]} shards; the group has {p} "
                "ranks -- resume on the same partition count or re-run the exchange"
            )
        return sharded_from_reference(arrays, self._rank(), p, group=self.group,
                                      names=payload["names"], device=device)


def _table_to_host(t) -> dict[str, Any]:
    from pim_sort_merge_join_tpu_torch.engine.distributed import ShardedTable

    if isinstance(t, Table):
        return {
            "kind": "table",
            "names": list(t.names),
            "arrays": {"data": t.data.cpu().numpy(), "num_rows": t.num_rows.cpu().numpy()},
        }
    if isinstance(t, ShardedTable):
        data, counts = t.host_arrays()
        return {"kind": "sharded", "names": list(t.names),
                "arrays": {"data": data, "counts": counts}}
    raise TypeError(f"cannot checkpoint {type(t)!r}")


def config_fingerprint(config) -> str:
    """Stable fingerprint of the parts of the config that affect state;
    equal to the JAX package's for a config with the same fields."""
    return json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
