"""Checkpoint / resume — full training state, async, integrity-checked;
the port of ``paddle_tpu/trainer/checkpoint.py``.

One artifact holds the parameters, the optimizer's slots and counters,
the layer state and the trainer's position (md5-verified meta, atomic
rename, keep-last-N, an async writer thread by default). Layout:
``<dir>/ckpt-<step:010d>/state.npz`` + ``meta.json``, the JAX package's
layout and flat key scheme (``params/<name>``, ``opt_state/step``,
``opt_state/num_samples``, ``opt_state/slots/<name>/<slot>``,
``state/<name>``): a checkpoint written by either package restores in
the other. The port's optimizer keeps ``step`` and ``num_samples`` as
host numbers; they are written as the JAX package's int32 and float32
scalars and read back as numbers.

The port's parameters are tensors its optimizer updates in place, so
``save`` returns only once the snapshot is a completed host copy (one
device -> host transfer, into memory nothing else holds); only
serialization and disk IO go to the ``pt-ckpt-writer`` thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.obs.events import emit as journal_emit
from paddle_tpu_torch.utils.stats import stat_timer

#: opt_state scalars the port keeps on the host, with the JAX package's
#: on-disk dtypes
_SCALARS = {"opt_state/step": np.int32, "opt_state/num_samples": np.float32}


def _flatten(tree, prefix="") -> Dict[str, Any]:
    """Nested dicts/lists of tensors and scalars -> flat {path: leaf}
    (the JAX package's key scheme, ``__empty__``/``__len__`` markers
    included)."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}__empty__"] = np.asarray(True)
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        out[f"{prefix}__len__"] = np.asarray(len(tree))
        out[f"{prefix}__tuple__"] = np.asarray(isinstance(tree, tuple))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """Inverse of _flatten."""
    if list(flat) == [""]:
        return flat[""]
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__empty__" in node:
            return {}
        if "__len__" in node:
            n = int(node["__len__"])
            seq = [rebuild(node[str(i)]) for i in range(n)]
            return tuple(seq) if bool(node.get("__tuple__", False)) else seq
        return {k: rebuild(v) for k, v in node.items() if k != "__tuple__"}

    return rebuild(root)


def _host_copy(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every leaf as a numpy array in memory of its own: the tensors of
    each device go to the host as one byte buffer (one transfer, no
    per-tensor sync) in pinned memory — PyTorch's host allocator caches
    the block, so a save reuses the one a finished write released, and
    the copy runs at the link's rate instead of first-touching fresh
    pageable pages — host tensors are copied. bfloat16 leaves are
    written as float32 (numpy has no bfloat16)."""
    out: Dict[str, np.ndarray] = {}
    by_dev: Dict[torch.device, List[str]] = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.float()
            flat[k] = v
            if v.device.type == "cpu":
                out[k] = v.numpy().copy()
            else:
                by_dev.setdefault(v.device, []).append(k)
        else:
            out[k] = np.array(v, dtype=_SCALARS.get(k))
    for keys in by_dev.values():
        parts = [flat[k].contiguous().reshape(-1).view(torch.uint8)
                 for k in keys]
        dev_buf = torch.cat(parts)
        host = torch.empty(dev_buf.numel(), dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(dev_buf)          # synchronous: complete on return
        buf = host.numpy()
        off = 0
        for k in keys:
            t = flat[k]
            n = t.numel() * t.element_size()
            dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            out[k] = buf[off:off + n].view(dt).reshape(tuple(t.shape))
            off += n
    return out


def _savez(path: str, flat: Dict[str, np.ndarray]) -> None:
    """The one place checkpoint bytes hit disk (tests patch THIS to
    simulate ENOSPC or a torn write at a chosen save or byte)."""
    with open(path, "wb") as f:
        np.savez(f, **flat)


class CheckpointManager:
    """Save/restore {params, opt_state, state, meta} with integrity meta.

    Async by default: save() makes the host snapshot synchronously — the
    only part that must see a consistent step — and hands serialization
    and disk IO to a background thread. Atomicity is by rename: a
    checkpoint directory appears only complete (state.npz + md5 meta
    written under .tmp, then os.replace), so a kill at ANY point leaves
    the previous checkpoint as the newest intact one. save() joins any
    previous in-flight write first (at most one writer), and
    restore()/SGD.train's exit call wait()."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, params, opt_state=None, state=None,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot to host synchronously; write to disk (in the
        background with ``async_write``). Returns the checkpoint path.
        Leaves are tensors (any device), numpy arrays or numbers."""
        user_meta = dict(meta or {})
        # fail fast ON the caller's thread: a non-JSON meta value must
        # not become a background failure surfaced one save later
        try:
            json.dumps(user_meta)
        except TypeError as e:
            raise TypeError(
                f"checkpoint meta must be JSON-serializable: {e}") from e
        with stat_timer("checkpoint/snapshot"):
            payload = {"params": params,
                       "opt_state": opt_state if opt_state is not None
                       else {},
                       "state": state if state is not None else {}}
            flat = _host_copy(_flatten(payload))
        path = os.path.join(self.dir, f"ckpt-{step:010d}")

        def write():
            with stat_timer("checkpoint/write"):
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                npz = os.path.join(tmp, "state.npz")
                _savez(npz, flat)
                with open(npz, "rb") as f:
                    digest = hashlib.md5(f.read()).hexdigest()
                m = {"step": step, "md5": digest, "meta": user_meta,
                     "keys": sorted(flat)}
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(m, f)
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.replace(tmp, path)
            # journaled at durability (after os.replace), not at intent
            journal_emit("checkpoint", "save", step=step, path=path,
                         background=self.async_write)
            self._gc()

        def write_guarded():
            try:
                write()
            except BaseException as e:   # surfaced by wait()/next save()
                self._write_error = e

        self.wait()
        if self.async_write:
            # non-daemon: a clean interpreter exit joins the thread, so a
            # caller that saves and returns cannot silently lose the write
            self._writer = threading.Thread(target=write_guarded,
                                            daemon=False,
                                            name="pt-ckpt-writer")
            self._writer.start()
        else:
            write()
        return path

    def writing(self) -> bool:
        """True while a background write is still running."""
        return self._writer is not None and self._writer.is_alive()

    def wait(self):
        """Join any in-flight async write (call before exit/restore).
        Re-raises a background write failure (ENOSPC, permissions...)
        — async must not turn a lost checkpoint into silence."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError(
                "background checkpoint write failed") from err

    def _gc(self):
        kept = self.all_steps()
        for s in kept[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt-{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        if not os.path.isdir(self.dir):
            return steps
        for name in os.listdir(self.dir):
            if name.startswith("ckpt-") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest step whose state passes its md5 check."""
        for s in reversed(self.all_steps()):
            if self._verify(s):
                return s
        return None

    def _verify(self, step: int) -> bool:
        path = os.path.join(self.dir, f"ckpt-{step:010d}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                m = json.load(f)
            with open(os.path.join(path, "state.npz"), "rb") as f:
                return hashlib.md5(f.read()).hexdigest() == m["md5"]
        except (OSError, KeyError, json.JSONDecodeError):
            return False

    def peek_meta(self, step: Optional[int] = None
                  ) -> Optional[Dict[str, Any]]:
        """The user meta of the newest intact (or given) checkpoint
        without loading its state."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"ckpt-{step:010d}", "meta.json")
        try:
            with open(path) as f:
                return json.load(f).get("meta", {})
        except (OSError, json.JSONDecodeError):
            return None

    def restore(self, step: Optional[int] = None
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Returns (step, {params, opt_state, state, meta}) with numpy
        leaves, or None. An explicit ``step`` gets the same md5 check
        latest_step() applies: a corrupt artifact raises instead of
        loading garbage parameters."""
        self.wait()
        explicit = step is not None
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"ckpt-{step:010d}")
        if explicit and not self._verify(step):
            raise RuntimeError(
                f"checkpoint {path} failed integrity verification "
                f"(md5 mismatch or missing/torn state) — refusing to "
                f"load a corrupt artifact")
        with open(os.path.join(path, "meta.json")) as f:
            m = json.load(f)
        with np.load(os.path.join(path, "state.npz"),
                     allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        tree = _unflatten(flat)
        tree["meta"] = m.get("meta", {})
        journal_emit("checkpoint", "restore", step=step, path=path)
        return step, tree
