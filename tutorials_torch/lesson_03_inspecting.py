"""Lesson 3: inspecting what gets compiled: loop nests + the HTML report
(reference: lesson_03/lesson_04 stmt output)."""
import halide_tpu_torch as hl
from halide_tpu_torch.loopnest import loop_nest_str
from halide_tpu_torch.report import pipeline_report_html


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    blur = hl.Func("blur")
    inp = hl.Func("inp")
    inp[x, y] = x + y
    inp.compute_root()
    blur[x, y] = (inp[x, y] + inp[x + 1, y]) / 2
    print(loop_nest_str(blur))
    html = pipeline_report_html(hl.Pipeline(blur))
    assert "blur" in html
    out = blur.realize([8, 4], device=device)
    assert out.at(3, 2) == (5 + 6) // 2
    print("lesson 03: report is", len(html), "bytes")


if __name__ == "__main__":
    main()
