"""paddle.v2.model — cloud-aware model save and load; the port of
``paddle_tpu/model.py``.

``save_model`` has two modes:

  - local: write ``parameters.to_tar`` to the given path (creating its
    parent directories);
  - cloud: every trainer calls in, but exactly one wins the
    coordinator's save election (``Coordinator.request_save_model``,
    trainer/coordinator.py) and writes ``<path>/<trainer_id>/model.tar``.

Cloud mode is on when ``PADDLE_TPU_COORDINATOR`` holds a coordinator's
``host:port`` (the address a ``CoordinatorServer`` or ``cli.py
coordinator`` prints); a coordinator of either package serves the
election.
"""

from __future__ import annotations

import os
import uuid

__all__ = ["save_model", "load_model"]

# one id per trainer process
trainer_id = str(uuid.uuid4())


def _coordinator_endpoint():
    ep = os.environ.get("PADDLE_TPU_COORDINATOR")
    if not ep:
        return None
    host, _, port = ep.rpartition(":")
    return host or "127.0.0.1", int(port)


def save_model(parameters, path: str, epoch: int = None,
               window_s: float = 30.0) -> bool:
    """Save ``parameters`` to ``path``; under a coordinator only the
    election's winner writes. Returns True if this process saved.

    ``epoch`` keys the election (one winner per epoch). Without it the
    coordinator grants one winner per ``window_s`` seconds, decided
    under its save lock, so two trainers straddling a pass turnover
    cannot both win. This process's ``trainer_id`` rides along: the
    current winner asking again is granted again, so a trainer saving
    faster than the window never skips a save."""
    ep = _coordinator_endpoint()
    if ep is not None:
        from paddle_tpu_torch.trainer.coordinator import connect
        if not connect(*ep).request_save_model(epoch, window_s,
                                               trainer_id):
            return False
        path = os.path.join(path, trainer_id, "model.tar")

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        parameters.to_tar(f)
    return True


def load_model(parameters, path: str) -> None:
    """Load ``path`` into an existing Parameters, in place
    (``Parameters.init_from_tar``)."""
    with open(path, "rb") as f:
        parameters.init_from_tar(f)
