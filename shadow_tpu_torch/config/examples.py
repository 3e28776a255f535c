"""Built-in example configuration behind `--test` (a copy of
shadow_tpu/config/examples.py; ref: examples.c —
the reference bakes in a 1000-client filetransfer XML; the same
1000-client bulk-download over one network vertex here, with
--test-clients to scale it down for quick smoke runs)."""

EXAMPLE_GRAPHML = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d4" />
  <key attr.name="latency" attr.type="double" for="edge" id="d3" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d2" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d1" />
  <graph edgedefault="undirected">
    <node id="poi-1">
      <data key="d1">10240</data>
      <data key="d2">10240</data>
    </node>
    <edge source="poi-1" target="poi-1">
      <data key="d3">50.0</data>
      <data key="d4">0.0</data>
    </edge>
  </graph>
</graphml>"""


def example_body(clients: int, kib: int, server_attrs: str = "",
                 client_attrs: str = "") -> str:
    """The plugin + hosts of the canonical bulk-download example —
    the single source of truth shared by `--test` (inline topology)
    and tools/generate_example_config.py (path topology +
    attachment-hint attrs)."""
    return f"""  <plugin id="filex" path="bulk"/>
  <host id="server" bandwidthdown="102400" bandwidthup="102400"{server_attrs}>
    <process plugin="filex" starttime="1" arguments="mode=server port=80"/>
  </host>
  <host id="client" quantity="{clients}"{client_attrs}>
    <process plugin="filex" starttime="2"
      arguments="mode=client server=server port=80 bytes={kib * 1024}"/>
  </host>"""


def example_config(clients: int = 1000, kib: int = 330,
                   stoptime: int = 60) -> str:
    """ref: example_getTestContents (examples.c:10-30)."""
    return f"""<shadow stoptime="{stoptime}">
  <topology><![CDATA[{EXAMPLE_GRAPHML}]]></topology>
{example_body(clients, kib)}
</shadow>"""
