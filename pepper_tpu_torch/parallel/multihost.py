"""Host identity for the port: single host only.

The JAX package stripes regions across hosts and gathers candidates through
the shared output directory (pepper_tpu/parallel/multihost.py). The port
runs on one host until that scale-out is ported (ROADMAP M7): every host
query answers for one host, and a configuration that asks for a coordinator
or several hosts raises `NotImplementedError`.
"""
import os
from typing import List, Optional, Sequence

_NOT_PORTED = ("multi-host runs are not yet ported to the PyTorch package "
               "(ROADMAP M7); run on one host")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Check that the run asks for one host; raise otherwise."""
    if num_processes is None:
        env = os.environ.get("PEPPER_TPU_NUM_HOSTS")
        num_processes = int(env) if env else None
    if coordinator_address or (num_processes is not None
                               and num_processes > 1):
        raise NotImplementedError(_NOT_PORTED)


def initialize_from_config(config) -> None:
    initialize(getattr(config, "coordinator_address", None),
               getattr(config, "num_hosts", None),
               getattr(config, "host_id", None))


def host_count() -> int:
    return 1


def host_index() -> int:
    return 0


def host_shard(items: Sequence) -> List:
    return list(items)


def host_tag() -> str:
    return ""


def gather_candidate_lists(output_dir: str, margin_list: list,
                           dv_list: list):
    """The single-host gather: this host's lists are the global lists."""
    return margin_list, dv_list
