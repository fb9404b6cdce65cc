from repro_torch.serving.events import (ReqState, RoundMetrics,
                                        ServingTimeModel, VirtualClock,
                                        latency_summary)
from repro_torch.serving.system import AgentSession, ServingSystem

__all__ = ["AgentSession", "ReqState", "RoundMetrics", "ServingSystem",
           "ServingTimeModel", "VirtualClock", "latency_summary"]
