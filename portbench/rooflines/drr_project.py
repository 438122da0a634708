"""The DRR projector (``liftreg::project``, tiles and sum one launch).
Bytes: the f32 attenuation, the geometry (x_pix, z_pix, dx), the f32
projections. Operations: 4 per two-tap interpolation, separable: per
(batch, view, plane) rd x H values along x and rd x rh along z."""
COUNTER = "drr_project"
PATTERNS = ("drr_project_tiles", "drr_project_sum")


def cost(s):
    geom = (s["P"] * s["W"] * (s["rd"] + s["rh"]) * 4
            + s["P"] * s["rd"] * s["rh"] * 4)
    nbytes = (s["B"] * s["D"] * s["W"] * s["H"] * 4 + geom
              + s["B"] * s["P"] * s["rd"] * s["rh"] * 4)
    ops = 4 * s["B"] * s["P"] * s["W"] * s["rd"] * (s["H"] + s["rh"])
    return nbytes, ops, "float32"
