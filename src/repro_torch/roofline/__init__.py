from .analysis import (H100, HW, CostCounter, collective_bytes, model_flops_6nd,
                       roofline_report)

__all__ = ["HW", "H100", "CostCounter", "collective_bytes", "roofline_report",
           "model_flops_6nd"]
