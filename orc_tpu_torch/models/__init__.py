"""Validation and benchmark cases."""

from orc_tpu_torch.models.channel_flow import (  # noqa: F401
    ChannelFlowParameters,
    analytical_profile,
    analytical_stats,
    couette_case,
    solve_channel_flow,
)
