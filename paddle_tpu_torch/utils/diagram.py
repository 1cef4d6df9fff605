"""Model topology -> Graphviz dot — the port of
``paddle_tpu/utils/diagram.py`` (python/paddle/utils/make_model_diagram.py).

The reference walks a protobuf ModelConfig and emits one box per layer with
``name: type, size`` labels and parent edges; here the graph is the
LayerOutput DAG the port's Topology already holds. Data layers are drawn as ovals and
cost/output heads double-peripheried, which is all the reference's diagram
conveys — no graphviz binary is needed to produce the .dot text.
"""

from __future__ import annotations

from typing import Union

__all__ = ["topology_to_dot", "make_diagram"]


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


def topology_to_dot(topology, graph_name: str = "model") -> str:
    """Render a Topology (or a single output LayerOutput) as dot text."""
    from paddle_tpu_torch.core.topology import Topology
    if not isinstance(topology, Topology):
        topology = Topology(topology)
    heads = {o.name for o in topology.outputs}
    lines = [f'digraph "{_esc(graph_name)}" {{',
             "  rankdir=BT;",  # inputs at the bottom, as the reference
             '  node [fontsize=10, shape=box];']
    for lyr in topology.layers:
        label = f"{lyr.name}\\n{lyr.type}, size={lyr.meta.size}"
        attrs = [f'label="{_esc(label)}"']
        if lyr.type == "data":
            attrs.append("shape=oval")
        if lyr.name in heads:
            attrs.append("peripheries=2")
        lines.append(f'  "{_esc(lyr.name)}" [{", ".join(attrs)}];')
    for lyr in topology.layers:
        for p in lyr.parents:
            lines.append(f'  "{_esc(p.name)}" -> "{_esc(lyr.name)}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def make_diagram(config_or_topology: Union[str, object], dot_path: str,
                 graph_name: str = "model") -> str:
    """Write the dot file for a topology object or a serialized-topology
    JSON path (make_model_diagram.py:usage 'config_file dot_file'). Returns
    the dot text."""
    topo = config_or_topology
    if isinstance(topo, str):
        from paddle_tpu_torch.core.topology import Topology
        with open(topo) as f:
            topo = Topology.deserialize(f.read())
    dot = topology_to_dot(topo, graph_name)
    with open(dot_path, "w") as f:
        f.write(dot)
    return dot
