"""Superstep-granular checkpoints for offline full-graph inference.

The port of `repro.launch.checkpoint`, in the same on-disk format:
a directory written by either package loads in the other.

`repro_torch.launch.full_graph_infer` runs NAI over a whole `GraphStore`
graph as a sequence of supersteps; a run at real graph scale is a
long-lived batch job that must survive preemption. This module is the
durability layer under it: a directory of per-superstep `.npy`
payloads committed behind ONE versioned, CRC32-checksummed manifest,
with atomic write-then-rename commits, so at every instant the
directory either names a complete, verifiable prefix of supersteps or
nothing — a crash at any point can never poison a resume.

Layout::

    <root>/MANIFEST.json          committed state (atomic os.replace)
    <root>/step_00000/x.npy       per-step payload arrays
    <root>/step_00000/exit_order.npy
    <root>/result/predictions.npy final outputs (committed like a step)

Invariants the tests pin:

* **Commit is atomic.** `save_step` writes every payload file, THEN
  rewrites the manifest via tmp-file + fsync + `os.replace`. A crash
  before the replace leaves trailing payload files that no manifest
  entry names — `steps()` never sees them, a resume ignores them.
* **Corruption is detected, typed, and recoverable.** Every payload
  file's CRC32 is recorded at commit; `load_step` re-checks it and
  raises `CheckpointCorruption` on any mismatch, truncation, or
  missing file, so the offline job can fall back to the previous complete
  superstep instead of resuming from garbage.
* **A checkpoint is bound to its run.** The manifest records a
  `fingerprint` (graph identity, shard count, backend, NAI config,
  padded geometry); opening the directory with a different
  fingerprint raises `CheckpointMismatch` — resuming a run onto the
  wrong graph or a different partitioning is an error, not a subtly
  wrong answer.
* **Bit-exact round-trip.** Payloads are `np.save`/`np.load` — dtype,
  shape, and every byte of the data come back identical (the
  round trips in tests/test_torch_offline.py).

Fault injection: an optional `FaultInjector`
(`repro_torch.serving.faults`) is consulted at the `ckpt_write` point
(after payloads, before the manifest commit — exactly the
crash-mid-checkpoint window) and the `ckpt_read` point (a committed
checkpoint reading back bad).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.gnn.store import _file_crc32
from repro_torch.serving.faults import InjectedFault

FORMAT = "repro-offline-ckpt-v1"
MANIFEST = "MANIFEST.json"
RESULT_KEY = "result"


class CheckpointError(RuntimeError):
    """Base class for checkpoint-directory failures."""


class CheckpointCorruption(CheckpointError):
    """A committed checkpoint failed verification (CRC mismatch,
    truncated or missing payload, unparseable manifest). The job's
    response is to fall back to the previous complete superstep."""


class CheckpointMismatch(CheckpointError):
    """The checkpoint directory belongs to a different run (format or
    fingerprint disagreement) — resuming would be silently wrong."""


def _fsync_dir(path: str) -> None:
    """Durably record a directory entry (the rename) itself."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _canon(obj) -> str:
    """Canonical JSON for fingerprint equality across processes."""
    return json.dumps(obj, sort_keys=True)


class CheckpointManager:
    """One run's checkpoint directory.

    `fingerprint` is any JSON-able dict identifying the run; a fresh
    directory adopts it, an existing one must match it exactly.
    `injector` is an optional `repro_torch.serving.faults.FaultInjector`
    consulted at the ``ckpt_write`` / ``ckpt_read`` stages.
    """

    def __init__(self, root: str, fingerprint: Optional[dict] = None,
                 *, injector=None):
        self.root = root
        self.injector = injector
        os.makedirs(root, exist_ok=True)
        self._manifest = self._read_manifest()
        if self._manifest is None:
            self._manifest = {"format": FORMAT,
                              "fingerprint": fingerprint,
                              "steps": {}, RESULT_KEY: None}
        elif fingerprint is not None:
            have = self._manifest.get("fingerprint")
            if _canon(have) != _canon(fingerprint):
                raise CheckpointMismatch(
                    f"checkpoint at {root} belongs to a different run: "
                    f"manifest fingerprint {have!r} != {fingerprint!r}")

    # ------------------------------------------------------- manifest
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    @property
    def fingerprint(self) -> Optional[dict]:
        return self._manifest.get("fingerprint")

    def _read_manifest(self) -> Optional[dict]:
        path = self.manifest_path
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruption(
                f"manifest {path} is not valid JSON ({e}); the commit "
                f"protocol makes this impossible short of external "
                f"damage — refusing to guess") from e
        if not isinstance(doc, dict) or not isinstance(
                doc.get("steps"), dict):
            raise CheckpointCorruption(
                f"manifest {path} has no steps table — damaged or "
                f"foreign file")
        if doc.get("format") != FORMAT:
            raise CheckpointMismatch(
                f"manifest {path} has format {doc.get('format')!r}, "
                f"this build reads {FORMAT!r}")
        return doc

    def _commit(self) -> None:
        """Atomic manifest rewrite: tmp + fsync + rename + dir fsync.
        Readers only ever see the previous or the new complete
        manifest, never a torn one."""
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.manifest_path)
        _fsync_dir(self.root)

    # ---------------------------------------------------------- steps
    def steps(self) -> List[int]:
        """Committed superstep ids, ascending. Payload directories with
        no manifest entry (a crash before commit) are invisible here."""
        return sorted(int(k) for k in self._manifest["steps"])

    def latest_complete(self, *, verify: bool = False) -> Optional[int]:
        """Highest committed superstep — with ``verify=True``, the
        highest k whose ENTIRE chain 0..k is committed and CRC-clean
        (a resume needs every earlier step's batch snapshot, so one
        corrupt ancestor invalidates everything above it)."""
        steps = self.steps()
        if not steps:
            return None
        if not verify:
            return steps[-1]
        have = set(steps)
        best = None
        for k in range(steps[-1] + 1):
            if k not in have:
                break
            try:
                self.verify_step(k)
            except CheckpointCorruption:
                break
            best = k
        return best

    def _write_payload(self, subdir: str,
                       arrays: Dict[str, np.ndarray]) -> dict:
        d = os.path.join(self.root, subdir)
        os.makedirs(d, exist_ok=True)
        files = {}
        for key, arr in arrays.items():
            path = os.path.join(d, f"{key}.npy")
            with open(path, "wb") as fh:
                np.save(fh, np.asarray(arr))
                fh.flush()
                os.fsync(fh.fileno())
            files[key] = {"crc32": _file_crc32(path),
                          "bytes": os.path.getsize(path)}
        return {"dir": subdir, "files": files}

    def _read_payload(self, entry: dict, what: str,
                      *, verify: bool = True) -> Dict[str, np.ndarray]:
        if self.injector is not None \
                and self.injector.fire("ckpt_read") is not None:
            raise CheckpointCorruption(
                f"injected read corruption on {what} (ckpt_read stage)")
        out = {}
        for key, rec in entry["files"].items():
            path = os.path.join(self.root, entry["dir"], f"{key}.npy")
            if not os.path.exists(path):
                raise CheckpointCorruption(
                    f"{what}: committed payload {path} is missing")
            if verify:
                got = _file_crc32(path)
                if got != rec["crc32"]:
                    raise CheckpointCorruption(
                        f"{what}: CRC mismatch on {path} "
                        f"(manifest {rec['crc32']}, file {got})")
            try:
                out[key] = np.load(path)
            except (ValueError, OSError, EOFError) as e:
                raise CheckpointCorruption(
                    f"{what}: unreadable payload {path}: {e}") from e
        return out

    def save_step(self, step: int,
                  arrays: Dict[str, np.ndarray]) -> None:
        """Write superstep `step`'s payload arrays, then commit the
        manifest. The ``ckpt_write`` injection point sits BETWEEN the
        two — exactly the crash-mid-checkpoint window the atomic commit
        protects against (payloads on disk, manifest never updated)."""
        entry = self._write_payload(f"step_{int(step):05d}", arrays)
        if self.injector is not None \
                and self.injector.fire("ckpt_write") is not None:
            raise InjectedFault(
                f"checkpoint write of superstep {step} crashed before "
                f"the manifest commit (ckpt_write stage)")
        self._manifest["steps"][str(int(step))] = entry
        self._commit()

    def load_step(self, step: int, *, verify: bool = True
                  ) -> Dict[str, np.ndarray]:
        entry = self._manifest["steps"].get(str(int(step)))
        if entry is None:
            raise CheckpointError(
                f"no committed checkpoint for superstep {step} "
                f"(have {self.steps()})")
        return self._read_payload(entry, f"superstep {step}",
                                  verify=verify)

    def verify_step(self, step: int) -> None:
        """CRC-check a committed step without loading the arrays."""
        entry = self._manifest["steps"].get(str(int(step)))
        if entry is None:
            raise CheckpointError(
                f"no committed checkpoint for superstep {step}")
        for key, rec in entry["files"].items():
            path = os.path.join(self.root, entry["dir"], f"{key}.npy")
            if not os.path.exists(path):
                raise CheckpointCorruption(
                    f"superstep {step}: committed payload {path} is "
                    f"missing")
            got = _file_crc32(path)
            if got != rec["crc32"]:
                raise CheckpointCorruption(
                    f"superstep {step}: CRC mismatch on {path} "
                    f"(manifest {rec['crc32']}, file {got})")

    # --------------------------------------------------------- result
    def save_result(self, arrays: Dict[str, np.ndarray]) -> None:
        """Commit the run's final outputs (same protocol as a step)."""
        entry = self._write_payload(RESULT_KEY, arrays)
        self._manifest[RESULT_KEY] = entry
        self._commit()

    def load_result(self, *, verify: bool = True
                    ) -> Optional[Dict[str, np.ndarray]]:
        entry = self._manifest.get(RESULT_KEY)
        if entry is None:
            return None
        return self._read_payload(entry, "result", verify=verify)

    def total_bytes(self) -> int:
        """Committed checkpoint bytes (steps only — the bench's
        checkpoint-overhead column)."""
        return sum(rec["bytes"]
                   for entry in self._manifest["steps"].values()
                   for rec in entry["files"].values())
