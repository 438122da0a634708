"""The projector's adjoint (``liftreg_drr_project_adjoint``). Bytes: the
f32 cotangent of the projections, the geometry, the f32 volume gradient.
Operations as the projector's, transposed."""
COUNTER = "drr_project_adjoint"
PATTERNS = ("adjoint_tiles",)


def cost(s):
    geom = (s["P"] * s["W"] * (s["rd"] + s["rh"]) * 4
            + s["P"] * s["rd"] * s["rh"] * 4)
    nbytes = (s["B"] * s["P"] * s["rd"] * s["rh"] * 4 + geom
              + s["B"] * s["D"] * s["W"] * s["H"] * 4)
    ops = 4 * s["B"] * s["P"] * s["W"] * s["rd"] * (s["rh"] + s["H"])
    return nbytes, ops, "float32"
