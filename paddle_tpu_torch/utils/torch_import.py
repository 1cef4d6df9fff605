"""Import torch weights into the port's Parameters — the port of
``paddle_tpu/utils/torch_import.py`` (python/paddle/utils/torch2paddle.py).

The reference reads serialized torch7 nn modules and copies tensors into
paddle parameter files in layer order. The modern equivalent is a
``state_dict``: ``import_torch_state_dict`` copies its tensors into an
existing :class:`Parameters`, either by an explicit ``name_map``
(our-name -> torch-key) or positionally in definition order, the
reference's convention (torch2paddle.py: layers are walked and assigned
sequentially).

Shape adaptation: ``torch.nn.Linear`` stores ``[out, in]`` while fc
parameters here are ``[in, out]`` (layers/base.py FCLayer.build), so a 2-D
source whose transposed shape matches is transposed; anything else must
match exactly or the import raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

__all__ = ["import_torch_state_dict"]


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):          # a torch.Tensor
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _fit(name: str, src: np.ndarray, want: tuple, transpose) -> np.ndarray:
    if transpose is True and src.ndim == 2:
        if tuple(src.T.shape) != tuple(want):
            raise ValueError(
                f"transpose=True but {name!r} source {tuple(src.shape)} "
                f"transposed does not give {tuple(want)}")
        return np.ascontiguousarray(src.T)
    if tuple(src.shape) == tuple(want):
        if transpose == "auto" and src.ndim == 2 and \
                src.shape[0] == src.shape[1]:
            import warnings
            warnings.warn(
                f"square 2-D tensor for {name!r}: transpose='auto' cannot "
                "tell a torch Linear [out,in] from a matching [in,out] "
                "layout — kept as-is; pass transpose=True (per-name via "
                "name_map ordering, or import it separately) if this came "
                "from torch.nn.Linear", stacklevel=3)
        return src
    if transpose == "auto" and src.ndim == 2 and \
            tuple(src.T.shape) == tuple(want):
        return np.ascontiguousarray(src.T)   # torch Linear [out,in] -> [in,out]
    raise ValueError(
        f"torch tensor for {name!r} has shape {tuple(src.shape)}, "
        f"parameter wants {tuple(want)}")


def import_torch_state_dict(parameters, state_dict: Mapping[str, object],
                            name_map: Optional[Dict[str, str]] = None,
                            strict: bool = True,
                            transpose="auto") -> int:
    """Copy torch tensors into ``parameters`` in place; returns the count.

    With ``name_map`` only the listed parameters load. Without it, the
    torch entries are assigned to parameters positionally (both sides in
    their definition order); ``strict`` then requires equal counts.

    ``transpose``: ``"auto"`` (default) transposes a 2-D source only when
    the exact shape does not fit but the transpose does — and warns on
    square matrices, where the two layouts are indistinguishable;
    ``True`` forces the Linear [out,in]->[in,out] transpose for every
    2-D tensor; ``False`` requires exact shape matches.
    """
    if name_map is None:
        pnames = list(parameters.keys())
        tkeys = list(state_dict.keys())
        if len(pnames) != len(tkeys):
            if strict:
                raise ValueError(
                    f"positional import needs equal counts: {len(pnames)} "
                    f"parameters vs {len(tkeys)} torch tensors "
                    "(pass name_map)")
            import warnings
            short, long_ = sorted((len(pnames), len(tkeys)))
            side = "parameters" if len(pnames) > len(tkeys) \
                else "torch tensors"
            warnings.warn(
                f"positional import with strict=False: {len(pnames)} "
                f"parameters vs {len(tkeys)} torch tensors — only the "
                f"first {short} pairs load, {long_ - short} trailing "
                f"{side} are skipped", stacklevel=2)
        name_map = dict(zip(pnames, tkeys))
    n = 0
    for pname, tkey in name_map.items():
        if tkey not in state_dict:
            raise KeyError(f"state_dict has no key {tkey!r} (for {pname!r})")
        want = tuple(parameters.raw[pname].shape)
        parameters[pname] = _fit(pname, _to_numpy(state_dict[tkey]), want,
                                 transpose)
        n += 1
    return n
