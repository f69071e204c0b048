"""lens_blur: depth-from-stereo + synthetic aperture bokeh
(reference: apps/lens_blur/lens_blur_generator.cpp:14-150, pyramid helpers
@281-296). The aperture sampling uses random_float, so the deterministic
conformance case is blur_radius_scale=0 (output == left/255); the stochastic
config is checked structurally."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _downsample(f, vars_):
    x, y = vars_[0], vars_[1]
    rest = tuple(vars_[2:])
    downx = hl.Func(f.name + "_dsx")
    downy = hl.Func(f.name + "_dsy")
    downx[vars_] = (f[(2 * x - 1, y) + rest]
                    + 3.0 * (f[(2 * x, y) + rest] + f[(2 * x + 1, y) + rest])
                    + f[(2 * x + 2, y) + rest]) / 8.0
    downy[vars_] = (downx[(x, 2 * y - 1) + rest]
                    + 3.0 * (downx[(x, 2 * y) + rest]
                             + downx[(x, 2 * y + 1) + rest])
                    + downx[(x, 2 * y + 2) + rest]) / 8.0
    return downy


def _upsample(f, vars_):
    x, y = vars_[0], vars_[1]
    rest = tuple(vars_[2:])
    upx = hl.Func(f.name + "_usx")
    upy = hl.Func(f.name + "_usy")
    # The reference writes the tap as f[x/2 - 1 + 2*(x%2)]: parity INSIDE
    # the index makes every read a gather. Moving parity into the WEIGHT
    # leaves two pure floor-div reads, which evaluate as slices.
    # Bit-exact: per parity the same two products are formed (x even:
    # 0.25*f[x/2-1] + 0.75*f[x/2]; x odd: 0.25*f[x/2+1] + 0.75*f[x/2]),
    # only the (commutative) addition order changes.
    wx = 0.75 - 0.5 * hl.f32(x % 2)
    upx[vars_] = wx * f[((x + 1) / 2, y) + rest] \
        + (1.0 - wx) * f[((x - 1) / 2, y) + rest]
    wy = 0.75 - 0.5 * hl.f32(y % 2)
    upy[vars_] = wy * upx[(x, (y + 1) / 2) + rest] \
        + (1.0 - wy) * upx[(x, (y - 1) / 2) + rest]
    return upy


@register("lens_blur")
def build(width: int = 192, height: int = 320, slices: int = 32,
          focus_depth: int = 13, blur_radius_scale: float = 0.5,
          aperture_samples: int = 32, levels: int = 8) -> App:
    x, y, z, c = hl.Var("x"), hl.Var("y"), hl.Var("z"), hl.Var("c")
    left_im = hl.ImageParam(hl.UInt(8), 3, "left_im")
    right_im = hl.ImageParam(hl.UInt(8), 3, "right_im")

    max_blur = int(max(slices - focus_depth, focus_depth)
                   * blur_radius_scale)
    left = hl.repeat_edge(left_im)
    right = hl.repeat_edge(right_im)

    diff = hl.Func("diff")
    diff[x, y, z, c] = hl.min(
        hl.absd(left[x, y, c], right[x + 2 * z, y, c]),
        hl.absd(left[x, y, c], right[x + 2 * z + 1, y, c]))

    cost = hl.Func("cost")
    cost[x, y, z] = (hl.pow(hl.f32(diff[x, y, z, 0]), 2.0)
                     + hl.pow(hl.f32(diff[x, y, z, 1]), 2.0)
                     + hl.pow(hl.f32(diff[x, y, z, 2]), 2.0))

    rs = hl.RDom(0, slices, "rs")
    cost_conf = hl.Func("cost_confidence")
    cost_conf[x, y] = (hl.sum(hl.pow(cost[x, y, rs.x], 2.0)) / slices
                       - hl.pow(hl.sum(cost[x, y, rs.x] / slices), 2.0))

    push = [hl.Func(f"cost_pyramid_push_{i}") for i in range(levels)]
    push[0][x, y, z, c] = hl.mux(
        c, [cost[x, y, z] * cost_conf[x, y], cost_conf[x, y]])
    push[0].compute_root()
    w_l, h_l = width, height
    bounded_push = [push[0]]
    for i in range(1, levels):
        push[i][x, y, z, c] = _downsample(bounded_push[i - 1],
                                          (x, y, z, c))[x, y, z, c]
        push[i].compute_root()
        w_l //= 2
        h_l //= 2
        bounded_push.append(hl.repeat_edge(push[i], [(0, w_l), (0, h_l)]))

    pull = [hl.Func(f"cost_pyramid_pull_{i}") for i in range(levels)]
    pull[levels - 1][x, y, z, c] = bounded_push[levels - 1][x, y, z, c]
    for i in range(levels - 2, -1, -1):
        pull[i][x, y, z, c] = hl.lerp(
            _upsample(pull[i + 1], (x, y, z, c))[x, y, z, c],
            bounded_push[i][x, y, z, c], 0.5)
        pull[i].compute_root()

    filtered_cost = hl.Func("filtered_cost")
    filtered_cost[x, y, z] = pull[0][x, y, z, 0] / pull[0][x, y, z, 1]

    rs2 = hl.RDom(0, slices, "rs2")
    depth = hl.Func("depth")
    depth[x, y] = hl.argmin(filtered_cost[x, y, rs2.x])[0]
    depth.compute_root()

    bokeh_radius = hl.Func("bokeh_radius")
    bokeh_radius[x, y] = hl.abs(depth[x, y] - focus_depth) \
        * blur_radius_scale
    bokeh_radius_sq = hl.Func("bokeh_radius_squared")
    bokeh_radius_sq[x, y] = hl.pow(bokeh_radius[x, y], 2.0)

    rw = hl.RDom(-max_blur, 2 * max_blur + 1, "rw") if max_blur > 0 else None
    worst_y = hl.Func("worst_case_bokeh_radius_y")
    worst = hl.Func("worst_case_bokeh_radius")
    if rw is not None:
        worst_y[x, y] = hl.maximum(bokeh_radius[x, y + rw.x])
        worst[x, y] = hl.maximum(worst_y[x + rw.x, y])
        # separable stages MUST be staged: inlined, the two 19-tap maxima
        # compose into a 361-tap dense reduction grid (~443 MB at
        # 640x480). The reference schedules worst_case_bokeh_radius_y at
        # tiles (lens_blur_generator.cpp).
        worst_y.compute_root()
    else:
        worst_y[x, y] = bokeh_radius[x, y]
        worst[x, y] = worst_y[x, y]
    worst.compute_root()

    input_with_alpha = hl.Func("input_with_alpha")
    input_with_alpha[x, y, c] = hl.mux(c, [
        hl.f32(left[x, y, 0]), hl.f32(left[x, y, 1]),
        hl.f32(left[x, y, 2]), hl.f32(255.0)])

    output = hl.Func("lens_out")
    output[x, y, c] = input_with_alpha[x, y, c]

    worst_radius = worst[x, y]
    su = (hl.random_float() - 0.5) * 2.0 * worst_radius
    sv = (hl.random_float() - 0.5) * 2.0 * worst_radius
    su = hl.clamp(hl.i32(su), -max_blur, max_blur)
    sv = hl.clamp(hl.i32(sv), -max_blur, max_blur)
    sample_locations = hl.Func("sample_locations")
    sample_locations[x, y, z] = (su, sv)
    sample_locations.compute_root()

    s = hl.RDom(0, aperture_samples, "s")
    su_z = sample_locations[x, y, z][0]
    sv_z = sample_locations[x, y, z][1]
    sample_x = x + su_z
    sample_y = y + sv_z
    r_sq = su_z * su_z + sv_z * sv_z
    in_bokeh_of_this = r_sq < bokeh_radius_sq[x, y]
    this_in_bokeh_of_sample = r_sq < bokeh_radius_sq[
        hl.clamp(sample_x, 0, width - 1), hl.clamp(sample_y, 0, height - 1)]
    in_front = depth[hl.clamp(sample_x, 0, width - 1),
                     hl.clamp(sample_y, 0, height - 1)] < depth[x, y]
    sample_weight = hl.Func("sample_weight")
    sample_weight[x, y, z] = hl.select(
        hl.logical_and(hl.logical_or(in_bokeh_of_this, in_front),
                       this_in_bokeh_of_sample), 1.0, 0.0)
    if max_blur == 0:
        # only the degenerate branch consumes it directly (the dense
        # branch folds the weight into the per-offset contraction below)
        sample_weight.compute_root()

    su_s = sample_locations[x, y, s.x][0]
    sv_s = sample_locations[x, y, s.x][1]
    if max_blur > 0:
        # The JAX app's accumulation: the naive form gathers input at a
        # data-dependent (su, sv) per (pixel, sample). Instead, histogram
        # the samples' offsets into a dense per-pixel weight plane over
        # the (2B+1)^2 offset window (a small-target scatter), then
        # accumulate STATIC shifted reads weighted by it:
        #   sum_s w_s * in[x+su_s, y+sv_s]
        #     == sum_k (sum_s w_s * [code_s == k]) * in[x+du_k, y+dv_k]
        # Same values (weights are 0/1 sums), no gathers anywhere.
        K = 2 * max_blur + 1
        bokeh_w = hl.Func("bokeh_w")
        bokeh_w[x, y, z] = 0.0
        # the use-site clamps are inert (sample_locations already clamps
        # to [-max_blur, max_blur]) but give the bounds engine a static
        # range for the scatter target
        su_c = hl.clamp(su_s, -max_blur, max_blur)
        sv_c = hl.clamp(sv_s, -max_blur, max_blur)
        # Count-only histogram: the reference's per-sample weight
        # (sample_weight above) reads bokeh_radius_sq/depth at the
        # SAMPLED coordinate -- a data-dependent 2-D gather per (pixel,
        # sample). But the weight is a function of (x, y, offset-code)
        # only, so for every code k:
        #   sum_s w_s * [code_s == k] == W_k(x, y) * sum_s [code_s == k]
        # Scatter raw counts here; fold W_k (static shifted reads of
        # depth / bokeh_radius_sq) into the per-offset contraction below.
        # Counts and 0/1 weights are small integers in f32: bit-exact, in
        # any order of the scatter's additions.
        bokeh_w[x, y, (su_c + max_blur) * K + (sv_c + max_blur)] += 1.0
        bokeh_w.compute_root()
        # statically-unrolled contraction (balanced add tree): every term
        # reads bokeh_w at a CONSTANT plane and the input at a CONSTANT
        # shift, so the whole sum is elementwise ops over static slices
        # -- an RDom form would bind the plane index per reduction point
        # and index per point
        terms = []
        for du in range(-max_blur, max_blur + 1):
            for dv in range(-max_blur, max_blur + 1):
                kk = (du + max_blur) * K + (dv + max_blur)
                rsq = du * du + dv * dv
                xb = hl.clamp(x + du, 0, width - 1)
                yb = hl.clamp(y + dv, 0, height - 1)
                w_k = hl.select(
                    hl.logical_and(
                        hl.logical_or(rsq < bokeh_radius_sq[x, y],
                                      depth[xb, yb] < depth[x, y]),
                        rsq < bokeh_radius_sq[xb, yb]), 1.0, 0.0)
                terms.append(
                    bokeh_w[x, y, kk] * w_k * input_with_alpha[
                        hl.clamp(x + du, -max_blur, width - 1 + max_blur),
                        hl.clamp(y + dv, -max_blur,
                                 height - 1 + max_blur), c])

        def _tree(ts):
            while len(ts) > 1:
                ts = [ts[i] + ts[i + 1] if i + 1 < len(ts) else ts[i]
                      for i in range(0, len(ts), 2)]
            return ts[0]

        output[x, y, c] += _tree(terms)
    else:
        output[x, y, c] += sample_weight[x, y, s.x] \
            * input_with_alpha[
                hl.clamp(x + su_s, -max_blur, width - 1 + max_blur),
                hl.clamp(y + sv_s, -max_blur, height - 1 + max_blur), c]

    final = hl.Func("final")
    final[x, y, c] = output[x, y, c] / output[x, y, 3]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (3, height, width + 2 * slices + 2),
                            np.uint8)
        return {"left_im": base[:, :, :width].copy(),
                "right_im": base[:, :, 2:width + 2].copy()}

    def reference(left_im, right_im):
        if blur_radius_scale == 0:
            return left_im.astype(np.float32) / np.float32(255.0)
        return None   # stochastic: structural checks only

    return App("lens_blur", hl.Pipeline(final),
               [left_im, right_im], make_inputs, reference,
               [width, height, 3], megapixels=width * height / 1e6,
               tolerance=1e-4, atol=1e-4)
