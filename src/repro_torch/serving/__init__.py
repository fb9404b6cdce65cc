from repro_torch.serving.events import (EventLoop, ReqState, RoundMetrics,
                                        ServingTimeModel, VirtualClock,
                                        latency_summary, slo_attainment)
from repro_torch.serving.system import AgentSession, ServingSystem

__all__ = ["AgentSession", "EventLoop", "ReqState", "RoundMetrics",
           "ServingSystem", "ServingTimeModel", "VirtualClock",
           "latency_summary", "slo_attainment"]
