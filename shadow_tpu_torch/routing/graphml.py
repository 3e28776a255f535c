"""GraphML ingestion (replaces the reference's igraph GML reader,
ref: topology.c:371-399, attribute schema topology.c:81-105,198-282).

Build-time, host-side, stdlib-only. The graph feeds
shadow_tpu_torch.routing.topology, which turns it into dense tables.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any

_NS = "{http://graphml.graphdrawing.org/xmlns}"

# Attribute schema the reference validates (topology.c:81-105):
GRAPH_ATTRS = {"preferdirectpaths"}
VERTEX_ATTRS = {
    "id", "ip", "citycode", "countrycode", "asn", "type",
    "packetloss", "bandwidthdown", "bandwidthup", "geocode",
}
EDGE_ATTRS = {"latency", "packetloss", "jitter"}


@dataclass
class Graph:
    directed: bool
    graph_attrs: dict[str, Any]
    # vertex i: dict with at least "id"; optional schema attrs above
    vertices: list[dict[str, Any]]
    # (src_index, dst_index, attrs) — attrs has "latency" (ms, float),
    # optional "packetloss" and "jitter"
    edges: list[tuple[int, int, dict[str, Any]]]
    vertex_index: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.vertex_index:
            self.vertex_index = {
                v["id"]: i for i, v in enumerate(self.vertices)
            }

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)


def _convert(value: str, attr_type: str):
    if attr_type in ("double", "float"):
        return float(value)
    if attr_type in ("int", "long", "integer"):
        return int(value)
    if attr_type in ("bool", "boolean"):
        return value.strip().lower() in ("1", "true", "yes")
    return value


def parse_graphml(text: str) -> Graph:
    """Parse a GraphML document (as the reference accepts from a file
    path or inline <topology> CDATA — configuration.h:45-47)."""
    root = ET.fromstring(text)

    def tag(el):  # namespace-agnostic tag name
        return el.tag.split("}")[-1]

    # <key id="d3" for="node" attr.name="bandwidthdown" attr.type="int"/>
    keys: dict[str, tuple[str, str, str]] = {}
    defaults: dict[str, Any] = {}
    for el in root:
        if tag(el) == "key":
            kid = el.get("id")
            name = el.get("attr.name", kid)
            ktype = el.get("attr.type", "string")
            keys[kid] = (el.get("for", "node"), name, ktype)
            for child in el:
                if tag(child) == "default" and child.text is not None:
                    defaults[kid] = _convert(child.text.strip(), ktype)

    graph_el = None
    for el in root:
        if tag(el) == "graph":
            graph_el = el
            break
    if graph_el is None:
        raise ValueError("graphml document has no <graph> element")
    directed = graph_el.get("edgedefault", "undirected") == "directed"

    def read_data(el, domain):
        attrs = {
            keys[k][1]: v
            for k, v in defaults.items()
            if k in keys and keys[k][0] == domain
        }
        for d in el:
            if tag(d) != "data":
                continue
            kid = d.get("key")
            if kid not in keys:
                continue
            _, name, ktype = keys[kid]
            attrs[name] = _convert((d.text or "").strip(), ktype)
        return attrs

    graph_attrs = read_data(graph_el, "graph")

    vertices: list[dict[str, Any]] = []
    vertex_index: dict[str, int] = {}
    edges: list[tuple[int, int, dict[str, Any]]] = []
    for el in graph_el:
        if tag(el) == "node":
            attrs = read_data(el, "node")
            attrs["id"] = el.get("id")
            vertex_index[attrs["id"]] = len(vertices)
            vertices.append(attrs)
    for el in graph_el:
        if tag(el) == "edge":
            attrs = read_data(el, "edge")
            s, t = el.get("source"), el.get("target")
            if s not in vertex_index or t not in vertex_index:
                raise ValueError(f"edge references unknown vertex {s}->{t}")
            if "latency" not in attrs:
                # required edge attribute (ref: topology.c:1066-1080)
                raise ValueError(f"edge {s}->{t} missing required latency")
            if float(attrs["latency"]) <= 0:
                raise ValueError(f"edge {s}->{t} has non-positive latency")
            edges.append((vertex_index[s], vertex_index[t], attrs))

    return Graph(
        directed=directed,
        graph_attrs=graph_attrs,
        vertices=vertices,
        edges=edges,
        vertex_index=vertex_index,
    )


def parse_graphml_path(path: str) -> Graph:
    import lzma

    if path.endswith(".xz"):
        with lzma.open(path, "rt") as f:
            return parse_graphml(f.read())
    with open(path) as f:
        return parse_graphml(f.read())
