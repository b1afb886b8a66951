"""Multi-host bootstrap.

Reference parity: none — the reference is single-process (SURVEY.md §5.8).
Equivalent here: `jax.distributed` process bootstrap; after
`init_distributed()`, `jax.devices()` spans all hosts and the mesh builders
in parallel/sharding.py work unchanged (the interconnect is XLA's
concern, not ours).
"""

from __future__ import annotations

import logging
from typing import Optional

import jax

log = logging.getLogger("lightpycl_tpu.distributed")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize jax.distributed (no-op when already initialized or when
    the environment provides the configuration). Without such an
    environment, pass all three arguments.
    Returns the number of global devices."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        log.info("jax.distributed: %s", e)
    n = len(jax.devices())
    log.info("distributed: %d processes, %d global devices",
             jax.process_count(), n)
    return n
