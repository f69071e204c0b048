"""Lesson 8: multi-stage pipelines -- compute_root vs compute_at
(reference: lesson_08)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "a b c d".split())
    producer, consumer = hl.Func("producer"), hl.Func("consumer")
    producer[x, y] = hl.sin(hl.f32(x * y) * 0.01)
    consumer[x, y] = (producer[x, y] + producer[x + 1, y]
                      + producer[x, y + 1] + producer[x + 1, y + 1]) / 4
    # default: producer inlined (one torch expression). Schedule it into
    # the consumer's tiles instead: one GPU kernel (K1), the producer
    # staged in shared memory.
    consumer.tile(x, y, xo, yo, xi, yi, 128, 32)
    producer.compute_at(consumer, xo)
    out = consumer.realize([256, 128], device=device).to_numpy()
    xs = np.arange(257)[None, :] * np.arange(129)[:, None]
    p = np.sin(xs.astype(np.float32) * np.float32(0.01))
    ref = (p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]) / 4
    np.testing.assert_allclose(out, ref, atol=1e-5)
    print("lesson 08: compute_at group matches")


if __name__ == "__main__":
    main()
