"""resnet_50 forward pass app (reference: apps/resnet_50). Every conv2d is
an RDom update that takes the convolution path
(eval_torch.try_conv_reduce, strides included) and fc the einsum path,
both f32 at full precision; the pools and the softmax are inline
reductions."""
from __future__ import annotations

from ..models import resnet50 as rn

from . import App, register


def _resnet_flops(p) -> float:
    """Conv+FC FLOPs per frame (multiply-add = 2), mirroring the exact
    block structure of models/resnet50.build (~4.1 GMACs/image at 224^2)."""
    macs = 0
    W = H = p.image
    # stem: 7x7 s2 3->width
    W, H = W // 2, H // 2
    macs += W * H * p.width * 3 * 49
    W, H = W // 2, H // 2      # maxpool
    ch = p.width
    for stage, nblocks in enumerate(p.layers):
        mid = p.width * (2 ** stage)
        out_ch = mid * 4
        for blk in range(nblocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            W2, H2 = W // stride, H // stride
            macs += W * H * ch * mid            # a: 1x1 at input spatial
            macs += W2 * H2 * mid * mid * 9     # b: 3x3 (strided)
            macs += W2 * H2 * mid * out_ch      # c: 1x1
            if stride != 1 or ch != out_ch:
                macs += W2 * H2 * ch * out_ch   # downsample 1x1
            ch = out_ch
            W, H = W2, H2
    macs += ch * p.classes                      # fc
    return 2.0 * macs * p.batch


@register("resnet_50")
def build(layers=(3, 4, 6, 3), width: int = 64, classes: int = 1000,
          image: int = 224, batch: int = 4, **_ignored) -> App:
    p = rn.ResNetParams(tuple(layers), width, classes, image, batch)
    pipeline, params, meta = rn.build(p)

    def make_inputs(seed=0):
        return rn.random_weights(p, seed)

    def reference(**data):
        return rn.reference(p, data)

    app = App("resnet_50", pipeline, list(params.values()), make_inputs,
              reference, [classes, batch],
              megapixels=image * image * batch / 1e6,
              tolerance=5e-3, atol=1e-5,
              flops=_resnet_flops(p))

    # fc's output before the softmax, the finer check where the softmax of
    # the random network is one-hot (models/resnet50.reference)
    app.logits_reference = lambda **data: rn.reference(p, data,
                                                       logits_only=True)
    return app
