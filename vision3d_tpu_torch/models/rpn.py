"""2D BEV backbones: the RPN (port of ``vision3d_tpu/models/rpn.py``) and
Voxel R-CNN's ``BaseBEVBackbone``.

``RPN``: one stride-1 3x3 Conv-BN-ReLU plus five more ("down block"), then
a 1x1 Conv-BN-ReLU ("up block"); 128 channels, BN eps 1e-3.
``BaseBEVBackbone`` (OpenPCDet ``backbones_2d/base_bev_backbone.py``, the
port's own: the JAX package has none): blocks at strides 1 and 2 of a 3x3
Conv-BN-ReLU then five more, each upsampled by a transposed conv + BN +
ReLU back to stride 1 and concatenated. NCHW in, NCHW out.
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
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False),
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


class BaseBEVBackbone(nn.Module):
    """Blocks ``i`` of ``1 + layer_nums[i]`` 3x3 Conv-BN-ReLU, the first at
    ``strides[i]`` (OpenPCDet's zero pad 1 then an unpadded conv: the same
    as padding 1), each block's output upsampled by a ``ConvTranspose2d``
    of kernel and stride ``up_strides[i]`` + BN + ReLU (``deblocks``) and
    the upsampled maps concatenated. BN eps 1e-3, momentum 0.01, as the
    published config builds them. The defaults are Voxel R-CNN's
    (``voxel_rcnn_car.yaml``): 64 and 128 wide, up to 128 + 128."""

    def __init__(self, c_in: int, layer_nums=(5, 5), strides=(1, 2), filters=(64, 128),
                 up_strides=(1, 2), up_filters=(128, 128)):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = c_in
        for n, s, c, us, uc in zip(layer_nums, strides, filters, up_strides, up_filters):
            self.blocks.append(nn.Sequential(ConvBNReLU(cin, c, stride=s),
                                             *[ConvBNReLU(c, c) for _ in range(n)]))
            self.deblocks.append(nn.Sequential(
                nn.ConvTranspose2d(c, uc, us, stride=us, bias=False),
                BatchNorm2d(uc, eps=1e-3, momentum=0.01), nn.ReLU(inplace=True)))
            cin = c
        self.c_out = sum(up_filters)

    def forward(self, x):
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        return torch.cat(ups, dim=1)
