"""The PCA expansion's backward (``liftreg_pca_grad``, its two passes one
launch): dcoefs = g @ basis^T. Bytes: the f32 cotangent, the basis, the
coefficients' gradient. Operations at the f32 peak."""
COUNTER = "pca_grad"
PATTERNS = ("pca_grad_partial_kernel", "pca_grad_finish_kernel")


def cost(s):
    n = 3 * s["D"] * s["W"] * s["H"]
    nbytes = (s["B"] * n * 4 + s["L"] * n * s["basis_bytes"]
              + s["B"] * s["L"] * 4)
    return nbytes, 2 * s["B"] * s["L"] * n, "float32"
