"""Balancer registry (reference: src/core/balancer_registry.c).

Ordered registry of algorithm classes; the first entry is the default.
"""

from __future__ import annotations

from typing import Optional, Type

from ceracoder_tpu_torch.control.adaptive import AdaptiveBalancer
from ceracoder_tpu_torch.control.aimd import AimdBalancer
from ceracoder_tpu_torch.control.fixed import FixedBalancer
from ceracoder_tpu_torch.control.types import Balancer

# First = default (reference: balancer_registry.c:39-44)
ALGORITHMS: tuple[Type[Balancer], ...] = (
    AdaptiveBalancer,
    FixedBalancer,
    AimdBalancer,
)


def balancer_get_default() -> Type[Balancer]:
    return ALGORITHMS[0]


def balancer_find(name: str) -> Optional[Type[Balancer]]:
    for algo in ALGORITHMS:
        if algo.name == name:
            return algo
    return None


def balancer_list_all() -> tuple[Type[Balancer], ...]:
    return ALGORITHMS


def balancer_available_text() -> str:
    lines = ["Available balancer algorithms:"]
    for i, algo in enumerate(ALGORITHMS):
        default = " (default)" if i == 0 else ""
        lines.append(f"  {algo.name:<10} {algo.description}{default}")
    return "\n".join(lines)
