"""Network topology as dense tables (host-side numpy).

The reference wraps an igraph graph and computes shortest paths lazily
per source with a RW-locked cache (ref: topology.c:1655-1875,
1969-2040); that design exists because CPU Dijkstra is expensive. On
an accelerator the idiom is the opposite: precompute all-pairs
latency/reliability once at build (Floyd-Warshall as vectorized numpy
relaxations, the same f64 operations in the same order as the
reference's lax.scan) and make every packet-send a pure 2D gather. Semantics preserved:

- path latency = sum of edge latencies (ms), floored at 1 ms
  (ref: topology.c:1849-1851)
- path reliability = prod(1 - edge loss) * (1 - src vertex loss) *
  (1 - dst vertex loss)  (ref: topology.c:1442-1460)
- complete graphs (every vertex incident to >= V edges, self-loop
  required) use the direct edge for every pair including self
  (ref: topology.c:450-520,2019-2031)
- `preferdirectpaths` graph attribute uses the direct edge for
  adjacent pairs (ref: topology.c:761-790,2019-2031)
- src == dst (and no direct rule): cheapest incident edge used twice,
  reliability = that edge's reliability squared, no vertex loss
  (ref: topology.c:1545-1653)
- min cross-host latency = the conservative window length ("min time
  jump", ref: master.c:450-480); here it is exact at build time
  instead of discovered lazily (ref: topology.c:1374-1385)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.routing.graphml import Graph

_INF = np.float64(np.inf)


def _ip_to_int(s: str | None) -> int | None:
    if not s:
        return None
    try:
        parts = [int(p) for p in s.split(".")]
    except ValueError:
        return None
    if len(parts) != 4 or any(p < 0 or p > 255 for p in parts):
        return None
    val = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
    # unusable: INADDR_ANY / INADDR_NONE / loopback
    # (ref: topology.c:2156-2162)
    if val == 0 or val == 0xFFFFFFFF or parts[0] == 127:
        return None
    return val


def _floyd_warshall(lat: np.ndarray, rel: np.ndarray):
    """All-pairs shortest path by latency, tracking path reliability.
    lat: [V,V] f64 (inf = no edge, diag = 0), rel: [V,V] f64."""
    d, r = lat.copy(), rel.copy()
    for k in range(lat.shape[0]):
        alt = d[:, k][:, None] + d[k, :][None, :]
        alt_rel = r[:, k][:, None] * r[k, :][None, :]
        better = alt < d
        d = np.where(better, alt, d)
        r = np.where(better, alt_rel, r)
    return d, r


@dataclass
class HostPlacement:
    """Result of attaching hosts to topology vertices."""

    vertex: np.ndarray        # [H] i32 vertex index per host
    bw_down_kibps: np.ndarray  # [H] i64 (vertex default unless host overrides)
    bw_up_kibps: np.ndarray    # [H] i64


class Topology:
    def __init__(self, graph: Graph):
        self.graph = graph
        V = graph.num_vertices
        if V == 0:
            raise ValueError("topology has no vertices")
        self.num_vertices = V

        vloss = np.array(
            [float(v.get("packetloss", 0.0)) for v in graph.vertices]
        )
        if ((vloss < 0) | (vloss > 1)).any():
            raise ValueError("vertex packetloss outside [0,1]")
        self.vertex_loss = vloss

        # adjacency (keep the cheapest parallel edge)
        elat = np.full((V, V), _INF)
        erel = np.ones((V, V))
        has_edge = np.zeros((V, V), dtype=bool)
        for s, t, attrs in graph.edges:
            lat = float(attrs["latency"])
            loss = float(attrs.get("packetloss", 0.0))
            if not (0.0 <= loss <= 1.0):
                raise ValueError(f"edge packetloss {loss} outside [0,1]")
            pairs = [(s, t)] if graph.directed else [(s, t), (t, s)]
            for a, b in pairs:
                has_edge[a, b] = True
                if lat < elat[a, b]:
                    elat[a, b] = lat
                    erel[a, b] = 1.0 - loss
        self.edge_latency = elat
        self.edge_reliability = erel
        self.has_edge = has_edge

        self._validate_connected()

        # complete = every vertex incident to every vertex incl. itself
        # (ref: topology.c:450-520)
        self.is_complete = bool(
            np.diag(has_edge).all() and has_edge.all()
        )
        self.prefers_direct_paths = bool(
            graph.graph_attrs.get("preferdirectpaths", False)
        ) or str(graph.graph_attrs.get("preferdirectpaths", "")).lower() in (
            "1", "true", "yes",
        )

        self._compute_paths()

    # -- build ---------------------------------------------------------

    def _validate_connected(self):
        """Strong connectivity (packets must flow both directions,
        ref: topology.c:735-742)."""
        V = self.num_vertices
        for adj in (self.has_edge, self.has_edge.T):
            seen = np.zeros(V, dtype=bool)
            seen[0] = True
            frontier = np.array([0])
            while frontier.size:
                nxt = adj[frontier].any(axis=0) & ~seen
                seen |= nxt
                frontier = np.flatnonzero(nxt)
            if not seen.all():
                raise ValueError(
                    "topology is not strongly connected; unreachable "
                    f"vertices: {np.flatnonzero(~seen)[:10].tolist()}"
                )

    def _compute_paths(self):
        V = self.num_vertices
        fw_lat = self.edge_latency.copy()
        np.fill_diagonal(fw_lat, 0.0)  # transit through a vertex is free
        fw_rel = self.edge_reliability.copy()
        np.fill_diagonal(fw_rel, 1.0)

        d, r = _floyd_warshall(fw_lat, fw_rel)

        if np.isinf(d).any():
            raise ValueError("no path between some vertex pair")

        # 1 ms floor for zero-latency multi-hop paths (topology.c:1849)
        off = ~np.eye(V, dtype=bool)
        d[off & (d <= 0.0)] = 1.0

        # endpoint vertex loss on non-self paths (topology.c:1442-1460)
        vrel = 1.0 - self.vertex_loss
        r = np.where(off, r * vrel[:, None] * vrel[None, :], r)

        # self paths: cheapest incident edge twice (topology.c:1545-1653)
        inc_lat = self.edge_latency.copy()
        best = inc_lat.argmin(axis=1)
        rows = np.arange(V)
        d[rows, rows] = 2.0 * inc_lat[rows, best]
        r[rows, rows] = self.edge_reliability[rows, best] ** 2

        # direct-path overrides (topology.c:2019-2031)
        if self.is_complete:
            direct = np.ones((V, V), dtype=bool)
        elif self.prefers_direct_paths:
            direct = self.has_edge.copy()
        else:
            direct = np.zeros((V, V), dtype=bool)
        if direct.any():
            # direct uses edge latency + both endpoint vertex losses
            # (same vertex applied twice on the diagonal, matching the
            # reference's lookupDirectPath quirk, topology.c:1901-1909)
            dl = self.edge_latency
            dr = self.edge_reliability * vrel[:, None] * vrel[None, :]
            d = np.where(direct & self.has_edge, dl, d)
            r = np.where(direct & self.has_edge, dr, r)

        self.latency_ms = d
        self.reliability = r
        # ns, rounded up exactly as the send path does
        # (worker.c:276: ceil(latency * SIMTIME_ONE_MILLISECOND))
        self.latency_ns = np.ceil(d * simtime.ONE_MILLISECOND).astype(np.int64)

    # -- attachment ----------------------------------------------------

    def find_attachment(
        self,
        rand_double: float,
        ip_hint: str | None = None,
        citycode: str | None = None,
        countrycode: str | None = None,
        geocode: str | None = None,
        type_hint: str | None = None,
    ) -> int:
        """Choose the vertex for one host following the reference's
        hint-specificity tiers (exact ip > city+type > city >
        country+type > country > geo+type > geo > type > all) with
        longest-prefix IP matching within the chosen tier
        (ref: topology.c:2126-2340)."""
        g = self.graph
        req_ip = _ip_to_int(ip_hint)

        vips = [_ip_to_int(v.get("ip")) for v in g.vertices]

        # exact IP match wins outright
        if req_ip is not None:
            exact = [i for i, ip in enumerate(vips) if ip == req_ip]
            if exact:
                n = len(exact)
                return exact[min(int(round((n - 1) * rand_double)), n - 1)]

        def match(v, key, hint):
            return hint is not None and str(v.get(key, "")).lower() == hint.lower()

        tiers: list[list[int]] = [[] for _ in range(8)]
        for i, v in enumerate(g.vertices):
            city = match(v, "citycode", citycode)
            country = match(v, "countrycode", countrycode)
            geo = match(v, "geocode", geocode)
            typ = match(v, "type", type_hint)
            if city and typ:
                tiers[0].append(i)
            if city:
                tiers[1].append(i)
            if country and typ:
                tiers[2].append(i)
            if country:
                tiers[3].append(i)
            if geo and typ:
                tiers[4].append(i)
            if geo:
                tiers[5].append(i)
            if typ:
                tiers[6].append(i)
            tiers[7].append(i)

        candidates = next(t for t in tiers if t)
        with_ips = [i for i in candidates if vips[i] is not None]
        if req_ip is not None and with_ips:
            # longest prefix match = maximize ~(vertexIP ^ ip) as u32
            # (ref: topology.c:2249-2287)
            return max(
                with_ips, key=lambda i: (~(vips[i] ^ req_ip)) & 0xFFFFFFFF
            )
        n = len(candidates)
        return candidates[min(int(round((n - 1) * rand_double)), n - 1)]

    def attach_hosts(self, hints: list[dict], rand_doubles) -> HostPlacement:
        """Attach H hosts given per-host hint dicts (keys: ip, citycode,
        countrycode, geocode, type, bandwidthdown, bandwidthup) and one
        uniform draw per host from the deterministic seed hierarchy."""
        H = len(hints)
        vertex = np.zeros(H, dtype=np.int32)
        bw_down = np.zeros(H, dtype=np.int64)
        bw_up = np.zeros(H, dtype=np.int64)
        for h, hint in enumerate(hints):
            vi = self.find_attachment(
                float(rand_doubles[h]),
                ip_hint=hint.get("ip"),
                citycode=hint.get("citycode"),
                countrycode=hint.get("countrycode"),
                geocode=hint.get("geocode"),
                type_hint=hint.get("type"),
            )
            vertex[h] = vi
            v = self.graph.vertices[vi]
            # host-element bandwidth overrides vertex default
            # (ref: host.c:162-220, master.c:304-398)
            bw_down[h] = int(hint.get("bandwidthdown", v.get("bandwidthdown", 0)))
            bw_up[h] = int(hint.get("bandwidthup", v.get("bandwidthup", 0)))
            if bw_down[h] <= 0 or bw_up[h] <= 0:
                raise ValueError(
                    f"host {h} has no bandwidth (hint or vertex "
                    f"bandwidthdown/up required)"
                )
        return HostPlacement(vertex=vertex, bw_down_kibps=bw_down, bw_up_kibps=bw_up)

    # -- queries -------------------------------------------------------

    def min_jump_ns(self, placement: HostPlacement) -> int:
        """Minimum latency between any two distinct hosts — the
        conservative window length. Exact version of the reference's
        lazily-updated min (topology.c:1374-1385, master.c:450-480),
        with the same 10 ms floor used when it cannot be determined
        (master.c:136-138)."""
        verts = np.unique(placement.vertex)
        counts = np.bincount(placement.vertex, minlength=self.num_vertices)
        best = np.int64(simtime.MAX)
        sub = self.latency_ns[np.ix_(verts, verts)].copy()
        if len(verts) > 1 or (counts[verts] > 1).any():
            same = np.eye(len(verts), dtype=bool)
            multi = counts[verts] > 1  # >=2 hosts on one vertex: self path counts
            diag = np.where(multi, np.diag(sub), simtime.MAX)
            off = np.where(~same, sub, simtime.MAX)
            best = min(int(off.min()), int(diag.min()))
        if best >= simtime.MAX:
            return 10 * simtime.ONE_MILLISECOND
        return max(int(best), 1)
