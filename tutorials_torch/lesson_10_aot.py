"""Lesson 10/15: AOT compilation via generators (reference: lesson_10,
lesson_15_generators)."""
import json
import os
import tempfile


def main(device=None):
    from halide_tpu_torch.tools import gen as gen_cli
    with tempfile.TemporaryDirectory() as out:
        args = ["-g", "blur", "-o", out, "-e", "hlpipe,stmt,metadata",
                "width=64", "height=48"]
        if device is not None:
            args += ["--device", str(device)]
        rc = gen_cli.main(args)
        assert rc == 0
        with open(os.path.join(out, "blur.metadata.json")) as fh:
            meta = json.load(fh)
        print("lesson 10: emitted", sorted(os.listdir(out)), "inputs:",
              [i["name"] for i in meta["inputs"]])


if __name__ == "__main__":
    main()
