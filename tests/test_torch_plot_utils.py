"""Port parity of ``plot.py``, ``utils/diagram.py``,
``utils/torch_import.py`` and ``utils/logging.py`` against the JAX
package's modules, on the CPU.

- ``Ploter`` collects the same series (DISABLE_PLOT and without).
- ``topology_to_dot`` / ``make_diagram`` give the same dot text for
  every golden topology (tests/golden, deserialized in both packages).
- ``import_torch_state_dict`` loads the same values into the port's
  ``Parameters`` as the reference into its own, from one ``state_dict``,
  named and positional, with the 2-D transpose rule; the mismatch
  errors are the same.
"""

import io
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import plot as jplot
from paddle_tpu.utils import diagram as jdiagram
from paddle_tpu.utils import torch_import as jti

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import plot as tplot
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.utils import diagram as tdiagram
from paddle_tpu_torch.utils import logging as tlogging
from paddle_tpu_torch.utils import torch_import as tti

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden")


def _series(plot):
    p = plot.Ploter("train cost", "test cost")
    for step in range(5):
        p.append("train cost", step, 1.0 / (step + 1))
        if step % 2 == 0:
            p.append("test cost", step, np.float32(2.0 - step * 0.1))
    out = {t: (p.data(t).step, p.data(t).value)
           for t in ("train cost", "test cost")}
    with pytest.raises(AssertionError):
        p.append("nope", 0, 1.0)
    p.plot()
    p.reset()
    return out, p.data("train cost").step


@pytest.mark.parametrize("disable", ["True", None])
def test_ploter_collects_like_jax(monkeypatch, tmp_path, disable):
    if disable is None:
        monkeypatch.delenv("DISABLE_PLOT", raising=False)
    else:
        monkeypatch.setenv("DISABLE_PLOT", disable)
    monkeypatch.chdir(tmp_path)
    jout, jafter = _series(jplot)
    tout, tafter = _series(tplot)
    assert tout == jout
    assert tafter == jafter == []
    assert tout["test cost"][0] == [0, 2, 4]
    assert all(type(v) is float for v in tout["test cost"][1])


def _goldens():
    return sorted(f[:-5] for f in os.listdir(GOLDEN)
                  if f.endswith(".json"))


@pytest.mark.parametrize("name", _goldens())
def test_diagram_matches_jax_on_golden_topologies(name, tmp_path):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        blob = f.read()
    jdot = jdiagram.topology_to_dot(jpaddle.Topology.deserialize(blob),
                                    name)
    tdot = tdiagram.topology_to_dot(TTopology.deserialize(blob), name)
    assert tdot == jdot
    path = tmp_path / "m.json"
    path.write_text(blob)
    assert tdiagram.make_diagram(str(path), str(tmp_path / "t.dot"),
                                 name) == jdot
    assert (tmp_path / "t.dot").read_text() == jdot
    assert tdot.startswith(f'digraph "{name}" {{')


def _mlp(pkg):
    """The same 3-layer MLP in a package (names reset): 6 parameters."""
    reg = __import__(pkg.__name__ + ".core.registry",
                     fromlist=["reset_name_counters"])
    reg.reset_name_counters()
    L = pkg.layer
    x = L.data("x", pkg.data_type.dense_vector(6))
    h = L.fc(x, size=5, act=pkg.activation.Relu())
    h = L.fc(h, size=5, act=pkg.activation.Tanh())
    out = L.fc(h, size=3, act=pkg.activation.Softmax())
    return pkg.create_parameters(pkg.Topology(out))


def _both():
    jpaddle.init(use_tpu=False, seed=0)
    tconfig.init(use_gpu=False, seed=0)
    try:
        return _mlp(jpaddle), _mlp(tpaddle)
    finally:
        tconfig.init(seed=0)


def _torch_mlp():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(),
                              torch.nn.Linear(5, 5), torch.nn.Tanh(),
                              torch.nn.Linear(5, 3))
    return net.state_dict()


def _values(params):
    return {k: np.asarray(params[k]) for k in params.keys()}


def test_import_state_dict_positional_matches_jax():
    jp, tp = _both()
    assert list(tp.keys()) == list(jp.names())
    sd = _torch_mlp()
    with pytest.warns(UserWarning, match="square 2-D"):
        nj = jti.import_torch_state_dict(jp, sd)
    with pytest.warns(UserWarning, match="square 2-D"):
        nt = tti.import_torch_state_dict(tp, sd)
    assert nt == nj == 6
    jv, tv = _values(jp), _values(tp)
    assert sorted(tv) == sorted(jv)
    for k in tv:
        np.testing.assert_array_equal(tv[k], jv[k])
    # the non-square Linear weights were transposed, biases kept
    first_w = list(tp.keys())[0]
    np.testing.assert_array_equal(tv[first_w],
                                  sd["0.weight"].numpy().T)


def test_import_state_dict_named_and_forced_transpose_match_jax():
    jp, tp = _both()
    sd = _torch_mlp()
    names = list(tp.keys())
    name_map = {names[2]: "2.weight", names[3]: "2.bias"}
    for transpose in (True, False):
        nj = jti.import_torch_state_dict(jp, sd, name_map=name_map,
                                         transpose=transpose)
        nt = tti.import_torch_state_dict(tp, sd, name_map=name_map,
                                         transpose=transpose)
        assert nt == nj == 2
        for k in name_map:
            np.testing.assert_array_equal(np.asarray(tp[k]),
                                          np.asarray(jp[k]))
    np.testing.assert_array_equal(np.asarray(tp[names[2]]),
                                  sd["2.weight"].numpy())
    # the errors are the same
    for kw, err in (({"name_map": {names[0]: "missing"}}, KeyError),
                    ({"name_map": {names[0]: "4.bias"}}, ValueError),
                    ({"name_map": {names[0]: "0.weight"},
                      "transpose": False}, ValueError)):
        with pytest.raises(err):
            jti.import_torch_state_dict(jp, sd, **kw)
        with pytest.raises(err):
            tti.import_torch_state_dict(tp, sd, **kw)
    short = dict(list(sd.items())[:4])
    with pytest.raises(ValueError, match="equal counts"):
        tti.import_torch_state_dict(tp, short)
    with pytest.warns(UserWarning, match="only the first 4 pairs"):
        assert tti.import_torch_state_dict(tp, short, strict=False,
                                           transpose=True) == 4


def test_logging_glog_format_and_version(capsys):
    log = tlogging.get_logger("paddle_tpu_torch.test")
    log.warning("hello %d", 3)
    err = capsys.readouterr().err
    assert err.startswith("[W ") and err.rstrip().endswith("hello 3")
    assert "test_torch_plot_utils.py:" in err
    tlogging.set_min_log_level(2)
    try:
        log.warning("hidden")
        assert capsys.readouterr().err == ""
    finally:
        tlogging.set_min_log_level(0)
    v = tlogging.version()
    assert v.startswith("paddle_tpu_torch 0.3.0") and "torch" in v
    buf = io.StringIO()
    print(v, file=buf)
    assert buf.getvalue().strip() == v
