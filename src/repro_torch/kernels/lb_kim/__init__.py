from repro_torch.kernels.lb_kim.ops import (
    lb_kim_features_launch,
    lb_kim_features_plain,
    lb_kim_launch,
    lb_kim_plain,
    lb_kim_qbatch_op,
)
from repro_torch.kernels.lb_kim.ref import lb_kim_qbatch_ref

__all__ = ["lb_kim_features_launch", "lb_kim_features_plain", "lb_kim_launch",
           "lb_kim_plain", "lb_kim_qbatch_op", "lb_kim_qbatch_ref"]
