from qadc_tpu_torch.eval.metrics import PhaseTimer, QueryMetrics
from qadc_tpu_torch.eval.recall import recall_at_r

__all__ = ["recall_at_r", "QueryMetrics", "PhaseTimer"]
