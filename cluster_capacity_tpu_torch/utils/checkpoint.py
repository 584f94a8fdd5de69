"""Tensorized-snapshot checkpointing and the resumable scenario journal.

The reference has no checkpoint/resume (each run re-snapshots and
discards); since the snapshot here IS a set of arrays, explicit save/load is
a new capability: an .npz bundle with the resource arrays plus the raw
objects, so repeated what-if sweeps skip both the API sync and the host
aggregation.  The bundle format is the JAX package's, byte for byte in its
members, so a bundle saved by either package loads in the other.

Integrity: every bundle embeds a sha256 over its tensors + names + objects;
`load` verifies it and raises CheckpointCorruption on a truncated, bit-rotted
or half-written file instead of deserializing garbage.  Bundles written
before the checksum existed load untouched.

ScenarioJournal is the resume mechanism for resilience sweeps: per-scenario
results append to a line-oriented journal (one self-checksummed JSON record
per line) as they complete, so a killed sweep restarts with `--resume` and
skips finished scenarios.  A line journal rather than rewriting the .npz per
scenario: appends are O(record) and crash-safe — a kill mid-write loses at
most the final partial line (tolerated and dropped on load), whereas a zip
archive's central directory only lands at close, so crashing mid-sweep would
corrupt the WHOLE journal, which is exactly the failure resume exists for.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Dict, List, Optional

import numpy as np

from ..models.snapshot import OBJECT_FIELDS as _AUX_FIELDS
from ..models.snapshot import ClusterSnapshot
from ..runtime.errors import CheckpointCorruption

_OBJECT_FIELDS = ("nodes",) + tuple(_AUX_FIELDS)

_ARRAY_KEYS = ("allocatable", "requested", "nonzero_requested")


def _norm(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _digest(arrays: Dict[str, np.ndarray], node_names: List[str],
            resource_names: List[str], objects_json: str) -> str:
    h = hashlib.sha256()
    for key in _ARRAY_KEYS:
        arr = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(json.dumps(node_names).encode())
    h.update(json.dumps(resource_names).encode())
    h.update(objects_json.encode())
    return h.hexdigest()


def _bundle(snapshot: ClusterSnapshot):
    """(arrays, objects_json) — the checksummed payload of a bundle."""
    objects = {f: getattr(snapshot, f) for f in _OBJECT_FIELDS}
    objects["pods_by_node"] = snapshot.pods_by_node
    objects_json = json.dumps(objects)
    arrays = {
        "allocatable": snapshot.allocatable,
        "requested": snapshot.requested,
        "nonzero_requested": snapshot.nonzero_requested,
    }
    return arrays, objects_json


def snapshot_digest(snapshot: ClusterSnapshot) -> str:
    """sha256 over the snapshot's tensors + axis names + raw objects — the
    same digest `save` embeds as the bundle checksum, usable as a content
    fingerprint for a live (unsaved) snapshot."""
    arrays, objects_json = _bundle(snapshot)
    return _digest(arrays, snapshot.node_names, snapshot.resource_names,
                   objects_json)


def save(path: str, snapshot: ClusterSnapshot) -> None:
    path = _norm(path)
    arrays, objects_json = _bundle(snapshot)
    np.savez_compressed(
        path,
        node_names=np.asarray(snapshot.node_names, dtype=object),
        resource_names=np.asarray(snapshot.resource_names, dtype=object),
        objects_json=np.asarray(objects_json),
        checksum=np.asarray(_digest(arrays, snapshot.node_names,
                                    snapshot.resource_names, objects_json)),
        **arrays,
    )


def load(path: str) -> ClusterSnapshot:
    path = _norm(path)
    try:
        with np.load(path, allow_pickle=True) as z:
            members = set(z.files)
            missing = [k for k in (*_ARRAY_KEYS, "node_names",
                                   "resource_names", "objects_json")
                       if k not in members]
            if missing:
                raise CheckpointCorruption(
                    f"checkpoint {path} is missing members "
                    f"{', '.join(missing)}",
                    detail={"path": path, "missing": missing})
            objects_json = str(z["objects_json"])
            node_names = [str(s) for s in z["node_names"]]
            resource_names = [str(s) for s in z["resource_names"]]
            arrays = {k: z[k] for k in _ARRAY_KEYS}
            if "checksum" in members:   # pre-checksum bundles load untouched
                want = str(z["checksum"])
                got = _digest(arrays, node_names, resource_names,
                              objects_json)
                if got != want:
                    raise CheckpointCorruption(
                        f"checkpoint {path} failed its checksum "
                        f"(expected {want[:12]}…, computed {got[:12]}…)",
                        detail={"path": path})
            objects = json.loads(objects_json)
    except (OSError, ValueError, KeyError, json.JSONDecodeError, EOFError,
            zipfile.BadZipFile) as exc:
        # Truncated/garbled archives surface as BadZipFile, EOFError or
        # ValueError depending on where the zip breaks; normalize every
        # unreadable bundle into the structured error.
        raise CheckpointCorruption(
            f"checkpoint {path} is unreadable: "
            f"{type(exc).__name__}: {exc}",
            detail={"path": path}) from exc
    return ClusterSnapshot(
        nodes=objects["nodes"],
        node_names=node_names,
        resource_names=resource_names,
        allocatable=arrays["allocatable"],
        requested=arrays["requested"],
        nonzero_requested=arrays["nonzero_requested"],
        pods_by_node=objects["pods_by_node"],
        **{f: objects.get(f, []) for f in _OBJECT_FIELDS if f != "nodes"},
    )


# --------------------------------------------------------------------------
# Resumable scenario journal
# --------------------------------------------------------------------------

_JOURNAL_VERSION = 1


def _line_for(record: dict) -> str:
    body = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(body.encode()).hexdigest() + " " + body + "\n"


class ScenarioJournal:
    """Append-only, per-line-checksummed journal of completed scenarios.

    Line format: ``<sha256hex> <compact-json>``.  The first record is a
    header carrying a fingerprint of the run configuration (probe, node
    count, limit, scenario-set hash, baseline headroom); `resume` refuses a
    journal whose fingerprint disagrees — resuming someone else's sweep
    would silently mix incompatible results.  A truncated FINAL line is the
    expected crash artifact and is dropped; a checksum mismatch anywhere
    earlier means the file was edited or bit-rotted and raises
    CheckpointCorruption.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    # -- writing -----------------------------------------------------------

    def start(self, fingerprint: dict) -> None:
        """Begin a fresh journal (truncates any existing file)."""
        header = {"kind": "header", "version": _JOURNAL_VERSION,
                  "fingerprint": fingerprint}
        self._fh = open(self.path, "w", encoding="utf-8")
        self._fh.write(_line_for(header))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def reopen(self) -> None:
        """Continue appending to an existing (validated) journal.  The crash
        that --resume recovers from may have left a half-written final line
        (read() tolerates and drops it); truncate the file back to the end
        of the last valid record first — appending onto the partial tail
        would weld two records into one mid-file line that every later
        read() rejects as corruption."""
        _, _, valid_end = self._scan()
        with open(self.path, "r+b") as fh:
            fh.truncate(valid_end)
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, name: str, payload: dict) -> None:
        if self._fh is None:
            raise RuntimeError("journal not started/reopened")
        self._fh.write(_line_for(
            {"kind": "scenario", "name": name, "result": payload}))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- reading -----------------------------------------------------------

    def read(self):
        """Returns (fingerprint, {scenario_name: payload}).  Tolerates a
        truncated final line; raises CheckpointCorruption on anything
        else."""
        fingerprint, done, _ = self._scan()
        return fingerprint, done

    def _scan(self):
        """(fingerprint, {scenario_name: payload}, valid_end) where
        valid_end is the byte offset just past the last valid record — the
        truncation point reopen() uses to discard a half-written tail."""
        fingerprint: Optional[dict] = None
        done: Dict[str, dict] = {}
        valid_end = 0
        try:
            with open(self.path, "rb") as fh:
                raw_lines = fh.read().splitlines(keepends=True)
        except OSError as exc:
            raise CheckpointCorruption(
                f"journal {self.path} is unreadable: {exc}",
                detail={"path": self.path}) from exc
        for i, raw in enumerate(raw_lines):
            line = raw.decode("utf-8", errors="replace")
            is_last = i == len(raw_lines) - 1
            record = self._parse_line(line, i, tolerate=is_last)
            if record is None:      # dropped truncated tail
                break
            valid_end += len(raw)
            if record.get("kind") == "header":
                if i != 0:
                    raise CheckpointCorruption(
                        f"journal {self.path}: header record at line "
                        f"{i + 1}", detail={"path": self.path})
                if record.get("version") != _JOURNAL_VERSION:
                    raise CheckpointCorruption(
                        f"journal {self.path}: unsupported version "
                        f"{record.get('version')}",
                        detail={"path": self.path})
                fingerprint = record.get("fingerprint") or {}
            elif record.get("kind") == "scenario":
                done[record["name"]] = record["result"]
        if fingerprint is None:
            raise CheckpointCorruption(
                f"journal {self.path} has no header record",
                detail={"path": self.path})
        return fingerprint, done, valid_end

    def _parse_line(self, line: str, index: int, *, tolerate: bool):
        text = line.rstrip("\n")
        if not text.strip():
            return None if tolerate else self._corrupt(index, "empty line")
        parts = text.split(" ", 1)
        if len(parts) != 2 or len(parts[0]) != 64:
            if tolerate and not line.endswith("\n"):
                return None
            return self._corrupt(index, "malformed record")
        digest, body = parts
        if hashlib.sha256(body.encode()).hexdigest() != digest:
            if tolerate and not line.endswith("\n"):
                return None
            return self._corrupt(index, "checksum mismatch")
        try:
            return json.loads(body)
        except json.JSONDecodeError:
            if tolerate and not line.endswith("\n"):
                return None
            return self._corrupt(index, "invalid JSON payload")

    def _corrupt(self, index: int, why: str):
        raise CheckpointCorruption(
            f"journal {self.path}: {why} at line {index + 1}",
            detail={"path": self.path, "line": index + 1})


def scenario_fingerprint(*, probe: dict, num_nodes: int, max_limit: int,
                         scenario_names: List[str],
                         baseline_headroom: int,
                         profile=None, snapshot=None) -> dict:
    """Run-identity fingerprint stored in the journal header.  Scenario
    names are hashed (a 10k-scenario random sweep should not bloat the
    header) in order — resume requires the same enumeration.

    `profile` (SchedulerProfile) and `snapshot` (ClusterSnapshot) pin the
    full run configuration: a profile edit that only changes drain
    re-scheduling, or a snapshot edit that happens to preserve the baseline
    headroom, must NOT pass the resume check — mixing their rows into one
    report would be silent corruption.  None omits the corresponding key
    (journal tests that never resume a real sweep)."""
    import dataclasses

    names_hash = hashlib.sha256(
        "\x00".join(scenario_names).encode()).hexdigest()
    probe_hash = hashlib.sha256(
        json.dumps(probe, sort_keys=True).encode()).hexdigest()
    fp = {"probe": probe_hash, "numNodes": int(num_nodes),
          "maxLimit": int(max_limit), "scenarios": names_hash,
          "baselineHeadroom": int(baseline_headroom)}
    if profile is not None:
        # default=str: exotic profile members (extenders with a default
        # repr) may fingerprint unstably, which fails SAFE — resume refuses
        # rather than accepting a journal it cannot vouch for
        fp["profile"] = hashlib.sha256(json.dumps(
            dataclasses.asdict(profile), sort_keys=True,
            default=str).encode()).hexdigest()
    if snapshot is not None:
        fp["snapshot"] = snapshot_digest(snapshot)
    return fp
