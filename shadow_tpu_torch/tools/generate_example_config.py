"""Generate example shadow.config.xml + GraphML topology files — the
analog of the reference's src/tools/generate_example_config.py
(the port's tools/generate_example_config.py).

Usage:
  python -m shadow_tpu_torch.tools.generate_example_config [-o DIR]
      [--clients N] [--kib K] [--vertices V] [--latency MS]

Writes DIR/shadow.config.xml and DIR/topology.graphml.xml; the config
references the topology by path, so `python -m shadow_tpu_torch.cli
DIR/shadow.config.xml` runs it directly.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def topology(vertices: int, latency_ms: float, bw_kibps: int) -> str:
    nodes = "\n".join(
        f'    <node id="v{i}"><data key="up">{bw_kibps}</data>'
        f'<data key="dn">{bw_kibps}</data>'
        f'<data key="ty">{"client" if i else "server"}</data></node>'
        for i in range(vertices))
    edges = []
    for i in range(vertices):
        edges.append(f'    <edge source="v{i}" target="v{i}">'
                     f'<data key="lat">{latency_ms / 2}</data></edge>')
        for j in range(i + 1, vertices):
            edges.append(f'    <edge source="v{i}" target="v{j}">'
                         f'<data key="lat">{latency_ms}</data></edge>')
    return f"""<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="type" attr.type="string" for="node" id="ty" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
{nodes}
{chr(10).join(edges)}
  </graph>
</graphml>"""


def config(clients: int, kib: int, stoptime: int) -> str:
    # one source of truth for the example body (config/examples.py)
    from shadow_tpu_torch.config.examples import example_body

    body = example_body(clients, kib, server_attrs=' typehint="server"',
                        client_attrs=' typehint="client"')
    return f"""<shadow stoptime="{stoptime}">
  <topology path="topology.graphml.xml"/>
{body}
</shadow>"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output-dir", default="example")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--kib", type=int, default=330)
    ap.add_argument("--stoptime", type=int, default=60)
    ap.add_argument("--vertices", type=int, default=2)
    ap.add_argument("--latency", type=float, default=50.0)
    ap.add_argument("--bandwidth", type=int, default=10240,
                    help="client vertex bandwidth (KiB/s)")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "topology.graphml.xml").write_text(
        topology(args.vertices, args.latency, args.bandwidth))
    (out / "shadow.config.xml").write_text(
        config(args.clients, args.kib, args.stoptime))
    print(f"wrote {out}/shadow.config.xml and {out}/topology.graphml.xml")
    print(f"run: python -m shadow_tpu_torch.cli {out}/shadow.config.xml")
    return 0


if __name__ == "__main__":
    sys.exit(main())
