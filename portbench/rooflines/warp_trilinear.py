"""The trilinear warp at phi (``liftreg::warp_trilinear``) of one channel.
Bytes: the taps, phi (f32), the f32 output. Operations: 50 a point (3 axes
x clip, floor, offset and two weights; 8 corners x 2 weight products, a
tap product and a sum) and 8 for phi's pixel coordinates and the rescale,
at the f32 peak."""
COUNTER = "warp_trilinear"
PATTERNS = ("warp_trilinear_kernel",)


def cost(s):
    m = s["D"] * s["W"] * s["H"]
    nbytes = s["B"] * m * s["taps_bytes"] + s["B"] * 3 * m * 4 + s["B"] * m * 4
    return nbytes, (50 + 8) * s["B"] * m, "float32"
