"""Lesson 15: generators -- reusable, parameterized pipeline recipes
(reference: tutorial/lesson_15_generators.cpp + lesson_15_generators_usage.sh).

A Generator bundles (inputs, GeneratorParams, algorithm, schedule) behind
a registered name. The gen CLI drives the same registry AOT:

  python -m halide_tpu_torch.tools.gen -g l15_brighten -o /tmp/out \\
      -e hlpipe,stmt,metadata factor=2
"""
import numpy as np
import halide_tpu_torch as hl
from halide_tpu_torch.generator import (Generator, GeneratorParam,
                                        register_generator, create)


@register_generator("l15_brighten")
class Brighten(Generator):
    factor = GeneratorParam(1)          # settable as factor=<int>
    sat = GeneratorParam(True)

    def generate(self):
        x, y = hl.Var("x"), hl.Var("y")
        self.inp = self.input_buffer("input", hl.UInt(8), 2)
        out = hl.Func("brighter")
        v = hl.u16(self.inp[x, y]) * self.factor
        if self.sat:
            out[x, y] = hl.u8(hl.min(v, 255))
        else:
            out[x, y] = hl.u8(v)
        return out


def main(device=None):
    # instantiate with parameters, build, bind, run
    gen = create("l15_brighten", factor=3, sat=True)
    pipe = gen.build_pipeline()
    img = np.arange(0, 25600, 100, np.uint16).astype(np.uint8)
    img = np.broadcast_to(img, (4, 256)).copy()
    gen.inputs[0].set(img)
    out = pipe.realize([256, 4], device=device).to_numpy()
    np.testing.assert_array_equal(
        out, np.minimum(img.astype(np.uint16) * 3, 255).astype(np.uint8))

    # the same generator, different params -> a different pipeline
    gen2 = create("l15_brighten", factor=2, sat=False)
    pipe2 = gen2.build_pipeline()
    gen2.inputs[0].set(img)
    out2 = pipe2.realize([256, 4], device=device).to_numpy()
    np.testing.assert_array_equal(
        out2, (img.astype(np.uint16) * 2).astype(np.uint8))
    print("lesson 15: generators OK")


if __name__ == "__main__":
    main()
