"""Generator driver CLI -- the GenGen analog
(reference: tools/GenGen.cpp + generate_filter_main @ Generator.cpp:663-760),
the counterpart of the JAX package's tools/gen.py.

Usage:
  python -m halide_tpu_torch.tools.gen -g blur -o out -e hlpipe,stmt,metadata
  python -m halide_tpu_torch.tools.gen -g blur -f my_blur -o out \\
      -e object --sizes 2558x1534 width=2560 height=1536
Flags mirror the reference: -g generator, -f function name, -o out dir,
-e emit list, -n file base name, --device (cpu; default the card) for the
lowered program of pysource and for object; free-form name=value set
GeneratorParams (an int, a float, ints joined by commas for a tuple such
as an app's tile=256,128, or a string).
"""
from __future__ import annotations

import sys

_EMITS = ["hlpipe", "stmt", "stmt_html", "metadata", "c_header", "object",
          "pysource"]


def _parse_value(v: str):
    """A GeneratorParam's value: an int, a float, a tuple of ints
    ("256,128", an app's tile), else the string."""
    for parse in (int, float):
        try:
            return parse(v)
        except ValueError:
            pass
    parts = v.split(",")
    if len(parts) > 1 and all(p.strip().lstrip("-").isdigit()
                              for p in parts):
        return tuple(int(p) for p in parts)
    return v


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from .. import generator as G

    gen_name = None
    fn_name = None
    out_dir = "."
    emits = ["hlpipe", "stmt", "metadata"]
    sizes = None
    device = None
    params = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-g":
            i += 1
            gen_name = argv[i]
        elif a == "-f":
            i += 1
            fn_name = argv[i]
        elif a == "-o":
            i += 1
            out_dir = argv[i]
        elif a == "-n":
            i += 1
            fn_name = argv[i]
        elif a == "-e":
            i += 1
            emits = [e.strip() for e in argv[i].split(",")]
        elif a == "--sizes":
            i += 1
            sizes = [int(v) for v in argv[i].replace("x", ",").split(",")]
        elif a == "--device":
            i += 1
            device = argv[i]
        elif a in ("-v", "--verbose"):
            pass
        elif a == "--list":
            print("\n".join(G.generator_names()))
            return 0
        elif "=" in a:
            k, v = a.split("=", 1)
            params[k] = _parse_value(v)
        else:
            print(f"unknown flag {a!r}", file=sys.stderr)
            return 1
        i += 1
    if gen_name is None:
        print("usage: gen -g <generator> [-o dir] [-e list] "
              "[param=value ...]; --list to enumerate", file=sys.stderr)
        return 1
    bad = [e for e in emits if e not in _EMITS]
    if bad:
        print(f"unknown -e outputs {bad}; valid: {_EMITS}", file=sys.stderr)
        return 1
    gen = G.create(gen_name, **params)
    written = G.emit_artifacts(gen, out_dir, fn_name or gen_name, emits,
                               sizes=sizes, device=device)
    for k, v in written.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
