"""The PCA expansion (``liftreg::pca_expand``): disp = coefs @ basis + mean.
Bytes: the coefficients, the basis, the mean, the f32 displacement.
Operations: a multiply and an add per coefficient and output, at the
basis type's peak."""
COUNTER = "pca_expand"
PATTERNS = ("pca_expand_kernel",)


def cost(s):
    n = 3 * s["D"] * s["W"] * s["H"]
    nbytes = (s["B"] * s["L"] * 4 + s["L"] * n * s["basis_bytes"] + n * 4
              + s["B"] * n * 4)
    return nbytes, 2 * s["B"] * s["L"] * n, s["basis_dtype"]
