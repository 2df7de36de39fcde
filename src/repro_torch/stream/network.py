"""Network performance model for the simulator (paper §6.1 Emulab setup).

Distance classes follow the paper's insight ladder (§4): intra-process <
inter-process < inter-node < inter-rack.  Latencies are one-way seconds;
bandwidths are bytes/second.
"""

from __future__ import annotations

import dataclasses

from ..core.cluster import Cluster


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    lat_intra_process: float = 5e-6
    lat_inter_process: float = 25e-6  # same node, cross-process (loopback)
    lat_inter_node: float = 250e-6    # same rack, through ToR switch
    lat_inter_rack: float = 2e-3      # half of the paper's 4 ms RTT
    nic_bw: float = 12.5e6            # 100 Mbps, bytes/s (per direction)
    rack_uplink_bw: float = 125e6     # 1 Gbps ToR uplink, bytes/s

    def latency(self, cluster: Cluster, node_a: str, node_b: str) -> float:
        if node_a == node_b:
            return self.lat_inter_process
        a, b = cluster.nodes[node_a], cluster.nodes[node_b]
        if a.rack_id == b.rack_id:
            return self.lat_inter_node
        return self.lat_inter_rack


# The paper's evaluation network.
EMULAB_NETWORK = NetworkModel()
