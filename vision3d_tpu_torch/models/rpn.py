"""2D BEV RPN backbone (port of ``vision3d_tpu/models/rpn.py``).

One stride-1 3x3 Conv-BN-ReLU plus five more ("down block"), then a 1x1
Conv-BN-ReLU ("up block"); 128 channels, BN eps 1e-3. NCHW in, NCHW out.
"""

from torch import nn


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
            nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01),
            nn.ReLU(inplace=True),
        )


class RPN(nn.Sequential):
    def __init__(self, c_in: int = 128, c_down: int = 128, c_up: int = 128,
                 blocks: int = 5):
        layers = [ConvBNReLU(c_in, c_down)]
        layers += [ConvBNReLU(c_down, c_down) for _ in range(blocks)]
        layers.append(ConvBNReLU(c_down, c_up, kernel=1))
        super().__init__(*layers)
