"""Set-up that the port's own code takes: its import, the app built at the
cell's size and the first realize, which plans and builds or loads K1
(host clock). Torch's import, the CUDA context, the input ring and the
warm-up frames are left out."""

PARTS = ("port_import_s", "app_build_s", "planning_realize_s")


def read(rec):
    setup = rec.get("setup")
    if not setup or any(k not in setup for k in PARTS):
        return None
    return sum(setup[k] for k in PARTS)
