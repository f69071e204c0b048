"""Plain PyTorch reference of resnet_50 (He, Zhang, Ren, Sun, "Deep
Residual Learning for Image Recognition", CVPR 2016, as Halide's
apps/resnet_50/Resnet50Generator.cpp builds it: ResNet-50 v1.5, the stride
of each downsampling block on its 3x3 convolution), the forward pass of
the port's app (models/resnet50.py), frozen here.

Inputs in the app's layouts: the image (n, y, x, c); each convolution's
weights (ci, ky, kx, co), its bias, its folded batch-norm scale and shift
(co,); fc's weights (ci, classes) and bias (classes,). Each convolution is
`F.conv2d` zero-padded by k // 2, each batch norm its scale and shift,
then a ReLU except after a block's last convolution and its downsample,
whose sum is added to the block's input before the ReLU. One departure
from torchvision's ResNet-50: the stem's 3x3 max pool pads with zeros
where torchvision pads with -inf, as the app's `nn.max_pool` does; it
follows a ReLU, so every value it reads is at least 0 and the two agree.

float32 with TF32 off in cuBLAS and cuDNN, the flags restored after.
`dtype` (the readings tool's lower-precision control passes bfloat16) is
the type every layer computes in; the probabilities come back in float32.

Imports nothing of the program under test.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _blocks(layers, width):
    """(name, stride, downsample) of each bottleneck block, in order."""
    ch = width
    for stage, nblocks in enumerate(layers):
        out_ch = width * 2 ** stage * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            yield f"res{stage}_{blk}", stride, stride != 1 or ch != out_ch
            ch = out_ch


def _forward(inputs: dict, args: dict, dtype) -> torch.Tensor:
    def t(name):
        return inputs[name].to(dtype)

    def conv_bn(x, name, stride, relu=True):
        w = t(f"{name}_w").permute(3, 0, 1, 2)     # (co, ci, ky, kx)
        k = w.shape[-1]
        y = F.conv2d(x, w, t(f"{name}_b"), stride=stride, padding=k // 2)
        y = y * t(f"{name}_s")[:, None, None] + t(f"{name}_o")[:, None, None]
        return F.relu(y) if relu else y

    x = t("image").permute(0, 3, 1, 2)              # (n, c, y, x)
    x = conv_bn(x, "conv1", 2)
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
    for name, stride, ds in _blocks(args["layers"], int(args["width"])):
        a = conv_bn(x, f"{name}_a", 1)
        b = conv_bn(a, f"{name}_b", stride)
        c = conv_bn(b, f"{name}_c", 1, relu=False)
        identity = conv_bn(x, f"{name}_ds", stride, relu=False) if ds else x
        x = F.relu(c + identity)
    pooled = x.mean(dim=(2, 3))                     # (n, c)
    logits = F.linear(pooled, t("fc_w").t(), t("fc_b"))
    return torch.softmax(logits, dim=1).float()


def reference(inputs: dict, args: dict, dtype=None) -> torch.Tensor:
    """-> the probabilities, float32 (n, classes)."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        return _forward(inputs, args, dtype or torch.float32)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved
