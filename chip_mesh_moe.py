"""Phase 49's MoE mode alone: ``chip_smoke.py``'s dp2 x ep2 run of the
MoE LM (four ranks on one card over gloo) against the single-process
port from the same weights and batch, beside the single-process run's
own spread (every initial weight scaled by 1 + 2^-22, and the batch's
rows reversed). Prints one JSON line: each run's losses, the worst and
median relative error in norm of the parameters' updates, and the mesh
run's ``step_ms`` and staged bytes a step.

Run on a CUDA machine from a tree that holds ``chip_smoke.py`` and the
port (``python3 chip_mesh_moe.py``, or ``python3 ../chip_mesh_moe.py``
from a second tree to measure that one's code).
"""

import json
import os
import shutil
import sys
import tempfile

import torch


def _errors(c, params, ref, tar):
    e = c._update_errors(params, ref, tar)
    worst = sorted(((v[0], k) for k, v in e.items()), reverse=True)[:4]
    return dict(worst=worst,
                median=sorted(v[0] for v in e.values())[len(e) // 2])


def main():
    if not torch.cuda.is_available():
        print("chip_mesh_moe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as c
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.trainer import create
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="mesh-moe-")
    try:
        cost, output, _, _ = c._mesh_net("moe")
        params = create(Topology(cost, extra_outputs=[output]),
                        torch.Generator().manual_seed(0))
        tar = os.path.join(work, "moe.tar")
        with open(tar, "wb") as f:
            params.to_tar(f)
        del params
        alone = c._mesh_train("moe", tar, None, {})
        ref = os.path.join(work, "ref.pt")
        torch.save({k: v.cpu() for k, v in alone.pop("params").items()},
                   ref)
        out = {"card": c.nvidia_smi_line(), "lr": c.MESH_LR,
               "alone": dict(losses=alone["losses"],
                             step_ms=alone["step_ms"])}
        for tag, kw in (("perturb", dict(perturb=c.MESH_SPREAD_EPS)),
                        ("reverse", dict(reverse=True))):
            r = c._mesh_train("moe", tar, None, {}, **kw)
            out[tag] = dict(losses=r["losses"],
                            **_errors(c, r["params"], ref, tar))
        modes = [m for m in c._mesh_modes(dict.fromkeys(
            ("lm", "moe", "sparse"), tar)) if m[0] == "d_dp2_ep2"]
        ranks = c._run_mesh_world(4, {"modes": modes,
                                      "refs": {"d_dp2_ep2": ref}}, work)
        r0 = ranks[0]["d_dp2_ep2"]
        e = r0["errors"]
        out["mesh"] = dict(
            losses=r0["losses"], step_ms=r0["step_ms"], staged=r0["staged"],
            worst=sorted(((v[0], k) for k, v in e.items()),
                         reverse=True)[:4],
            median=sorted(v[0] for v in e.values())[len(e) // 2])
        print(json.dumps(out), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
