# Stream-processing substrate the search needs: the Storm-like topology
# builder API, the network model, the paper's evaluation topologies and the
# steady-state throughput simulator (the never-worse referee of
# ``objective="throughput"`` searches).
from .api import TopologyBuilder
from .network import NetworkModel, EMULAB_NETWORK
from .simulator import SimResult, Simulator, simulate
from . import topologies

__all__ = [
    "TopologyBuilder",
    "NetworkModel",
    "EMULAB_NETWORK",
    "Simulator",
    "SimResult",
    "simulate",
    "topologies",
]
