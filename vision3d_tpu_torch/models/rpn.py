"""2D BEV RPN backbone (port of ``vision3d_tpu/models/rpn.py``).

One stride-1 3x3 Conv-BN-ReLU plus five more ("down block"), then a 1x1
Conv-BN-ReLU ("up block"); 128 channels, BN eps 1e-3. NCHW in, NCHW out.
"""

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.parallel import mesh


class BatchNorm2d(nn.BatchNorm2d):
    """``torch.nn.BatchNorm2d`` whose running variance is updated with the
    BIASED batch variance, as flax's ``nn.BatchNorm`` does (torch uses the
    unbiased one, n/(n-1) larger). Parameters and state_dict names are
    torch's. A training forward normalises with the batch statistics
    through torch's own kernel and makes the running update itself. On
    several ranks the statistics are the global batch's: the sum and then
    the centred sum all-reduced (two passes), the same for the running
    update (``torch.nn.SyncBatchNorm`` would update it with the unbiased
    variance)."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if mesh.world_size() > 1:
            n = x.numel() // x.shape[1] * mesh.world_size()
            mean = mesh.global_sum(x.sum(dim=(0, 2, 3))) / n
            xc = x - mean[:, None, None]
            var = mesh.global_sum(xc.square().sum(dim=(0, 2, 3))) / n
            y = (xc * (torch.rsqrt(var + self.eps) * self.weight)[:, None, None]
                 + self.bias[:, None, None])
            mean, var = mean.detach(), var.detach()
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                             self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01),
            nn.ReLU(inplace=True),
        )


class RPN(nn.Sequential):
    def __init__(self, c_in: int = 128, c_down: int = 128, c_up: int = 128,
                 blocks: int = 5):
        layers = [ConvBNReLU(c_in, c_down)]
        layers += [ConvBNReLU(c_down, c_down) for _ in range(blocks)]
        layers.append(ConvBNReLU(c_down, c_up, kernel=1))
        super().__init__(*layers)
