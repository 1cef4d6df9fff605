"""Inference — the port of ``paddle_tpu/trainer/inference.py``:
``Inference``, ``infer`` and the merged inference artifact
(``save_inference_model`` / ``load_inference_model``, one tar holding
``topology.json`` and ``params.tar``, so an artifact written by either
package loads in the other).

``infer(output_layer=..., parameters=..., input=...)`` runs the forward
pass eagerly under ``torch.no_grad()`` in test mode, batch by batch, and
returns numpy outputs. It runs on ``device`` (the CUDA card unless the
CPU is asked for); parameters living elsewhere are read onto it.
"""

from __future__ import annotations

import io
import tarfile
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.parameters import Parameters


class Inference:
    def __init__(self, output_layer=None, parameters: Parameters = None,
                 topology: Optional[Topology] = None,
                 device: DeviceLike = None):
        if topology is None:
            outputs = output_layer if isinstance(output_layer, (list, tuple)) \
                else [output_layer]
            topology = Topology(list(outputs))
        self.topology = topology
        self.parameters = parameters
        self.output_names = [o.name for o in topology.outputs]
        self.device = resolve_device(device)
        self._default_feeder: Optional[DataFeeder] = None

    def _on_device(self, tensors):
        return {k: v.to(self.device) for k, v in tensors.items()}

    def forward_batch(self, samples, feeding=None) -> List[np.ndarray]:
        """ONE batch through the forward; a list of numpy arrays, one per
        output (a sequence output gives its padded data)."""
        if feeding is None:
            if self._default_feeder is None:
                self._default_feeder = DataFeeder(
                    self.topology.data_type(), None, device=self.device)
            feeder = self._default_feeder
        else:
            feeder = DataFeeder(self.topology.data_type(), feeding,
                                device=self.device)
        feed = feeder(samples)
        feed.pop("__batch_size__", None)
        params = {k: self.parameters.raw[k]
                  for k in self.topology.param_specs}
        with torch.no_grad():
            outs, _ = self.topology.forward(
                self._on_device(params),
                self._on_device(self.parameters.state), feed, mode="test",
                output_names=self.output_names)
            vals = [outs[n] for n in self.output_names]
            return [(v.data if isinstance(v, SequenceBatch) else v)
                    .detach().cpu().numpy() for v in vals]

    def iter_infer_field(self, input, feeding=None, batch_size: int = 128):
        for start in range(0, len(input), batch_size):
            yield self.forward_batch(input[start:start + batch_size],
                                     feeding)

    def infer(self, input, field="value", feeding=None,
              batch_size: int = 128):
        results: Optional[List[List[np.ndarray]]] = None
        for outs in self.iter_infer_field(input, feeding, batch_size):
            if results is None:
                results = [[] for _ in outs]
            for i, o in enumerate(outs):
                results[i].append(o)
        if results is None:
            return None
        cat = [np.concatenate(r, axis=0) for r in results]
        return cat[0] if len(cat) == 1 else cat


def infer(output_layer, parameters: Parameters, input, field="value",
          feeding=None, batch_size: int = 128, device: DeviceLike = None):
    """paddle.infer: the outputs of ``output_layer`` on ``input`` (a list
    of sample tuples), as numpy."""
    return Inference(output_layer, parameters, device=device).infer(
        input, field=field, feeding=feeding, batch_size=batch_size)


# ---------------------------------------------------------------------------
# the merged inference artifact


def save_inference_model(path: str, output_layer,
                         parameters: Parameters) -> str:
    """One deployable file: the serialized topology of ``output_layer``
    and every parameter (a tar of ``topology.json`` and
    ``params.tar``)."""
    outputs = output_layer if isinstance(output_layer, (list, tuple)) \
        else [output_layer]
    topo = Topology(list(outputs))
    with tarfile.open(path, "w") as tf:
        blob = topo.serialize().encode()
        info = tarfile.TarInfo("topology.json")
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))
        buf = io.BytesIO()
        parameters.to_tar(buf)
        b = buf.getvalue()
        info = tarfile.TarInfo("params.tar")
        info.size = len(b)
        tf.addfile(info, io.BytesIO(b))
    return path


def load_inference_model(path: str, device: DeviceLike = None) -> Inference:
    """A ready Inference from a save_inference_model artifact, on
    ``device``. A missing, torn or foreign file raises ValueError naming
    the artifact."""
    if isinstance(path, bytes):
        path = path.decode()
    try:
        with tarfile.open(path, "r") as tf:
            names = set(tf.getnames())
            missing = {"topology.json", "params.tar"} - names
            if missing:
                raise ValueError(
                    f"{path!r} is not an inference artifact: missing "
                    f"{sorted(missing)} (have {sorted(names)})")
            blob = tf.extractfile("topology.json").read()
            pbytes = tf.extractfile("params.tar").read()
    except (OSError, tarfile.TarError) as e:
        raise ValueError(
            f"cannot load inference artifact {path!r}: {e}") from e
    try:
        topo = Topology.deserialize(blob)
        params = Parameters.from_tar(io.BytesIO(pbytes), device=device)
    except Exception as e:
        raise ValueError(
            f"inference artifact {path!r} is corrupt: {e}") from e
    return Inference(parameters=params, topology=topo, device=device)
