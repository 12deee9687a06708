"""Rate-control core: pluggable bitrate balancers with reference-exact
semantics (reference: src/balancer.h, src/core/bitrate_control.c,
src/core/balancer_{adaptive,aimd,fixed,registry,runner}.c).

Pure and clock-injected: every step takes an explicit timestamp, so the
whole controller can be driven with synthetic stat traces in tests
(reference: tests/test_balancer.c strategy).
"""

from ceracoder_tpu_torch.control.types import (
    BalancerConfig,
    BalancerInput,
    BalancerOutput,
)
from ceracoder_tpu_torch.control.registry import (
    balancer_find,
    balancer_get_default,
    balancer_list_all,
)
from ceracoder_tpu_torch.control.runner import BalancerRunner
from ceracoder_tpu_torch.control.config import CeracoderConfig

__all__ = [
    "BalancerConfig",
    "BalancerInput",
    "BalancerOutput",
    "BalancerRunner",
    "CeracoderConfig",
    "balancer_find",
    "balancer_get_default",
    "balancer_list_all",
]
