"""The warp's coordinate gradient (``liftreg_warp_coord_grad_phi``) of one
channel. Bytes: the taps, phi, the cotangent, dphi. Operations: 24 for the
weights and their derivatives and 8 x 3 x 4 for the corners a point, and
10 for phi's coordinates, the doubled cotangent and dphi's scale, at the
f32 peak."""
COUNTER = "warp_coord_grad"
PATTERNS = ("warp_coord_grad_kernel",)


def cost(s):
    m = s["D"] * s["W"] * s["H"]
    nbytes = (s["B"] * m * s["taps_bytes"] + 2 * s["B"] * 3 * m * 4
              + s["B"] * m * 4)
    return nbytes, (24 + 8 * 3 * 4 + 10) * s["B"] * m, "float32"
