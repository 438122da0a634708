"""The lift into the encoder's input (``liftreg::encoder_input``; its
launch counts as the lift's). Bytes: the f32 projections, the lift's
geometry (u_pix, v_pix), the P lifted channels in the buffer's type, and
the moving CT read in f32 and written into channel 0. Operations: 4 per
two-tap interpolation, separable: per (batch, view, plane) D x ph values
along u and D x H along v."""
COUNTER = "drr_backproject"
PATTERNS = ("drr_backproject_rows",)


def cost(s):
    m = s["D"] * s["W"] * s["H"]
    nbytes = (s["B"] * s["P"] * s["rd"] * s["rh"] * 4
              + s["P"] * s["W"] * (s["D"] + s["H"]) * 4
              + s["B"] * s["P"] * m * s["lift_bytes"]
              + s["B"] * m * (4 + s["lift_bytes"]))
    ops = 4 * s["B"] * s["P"] * s["W"] * s["D"] * (s["rh"] + s["H"])
    return nbytes, ops, "float32"
