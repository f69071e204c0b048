"""Lesson 18: parallelizing associative reductions with rfactor
(reference: tutorial/lesson_18_parallel_associative_reductions.cpp).

A serial reduction over an RDom has a loop-carried dependence. rfactor
splits the domain, gives each slice its own independent partial result
(a new pure dimension), and reduces the partials -- legal only when the
combine is associative, which the associativity prover checks (the
reference's src/AssociativeOpsTable). On the card the partials become
one batched torch reduction instead of a serial loop.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    rng = np.random.default_rng(18)
    img = rng.integers(0, 1000, (64, 96), np.int32)
    inp = hl.Buffer(img, name="l18_in")

    # serial histogram-style total
    total = hl.Func("l18_total")
    total[x] = 0
    r = hl.RDom(0, 96, 0, 64, "r")
    total[x] += inp[r.x, r.y]

    # factor the y-axis of the domain out into a new pure dimension:
    # 64 independent row partials reduced at the end
    u = hl.Var("u")
    intm = total.update().rfactor(r.y, u)    # partials indexed by u
    intm.compute_root()
    got = int(total.realize([1], device=device).to_numpy()[0])
    assert got == int(img.sum())

    # non-associative combines are rejected when the schedule is set
    # unless you take responsibility with
    # atomic(override_associativity_test=True)
    bad = hl.Func("l18_bad")
    bad[x] = hl.f32(1.0)
    r2 = hl.RDom(1, 8, "r2")
    bad[x] = bad[x] / (hl.f32(r2) + 2.0)     # division: not associative
    try:
        bad.update().rfactor(r2.x, hl.Var("v"))
        raise AssertionError("rfactor of non-associative combine passed")
    except hl.CompileError as e:
        print("lesson 18: non-associative rfactor rejected:",
              str(e)[:60])
    print("lesson 18: rfactor total =", got)


if __name__ == "__main__":
    main()
