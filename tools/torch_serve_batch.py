"""Batch-serve registrations from a port serving artifact over a case
directory: the counterpart of ``tools/torch_export_serving.py``. Loads one
``.liftreg`` artifact (``liftreg_tpu_torch/serving.py``) and registers
every case found in ``--input``, up to the artifact's exported batch per
call (a partial last batch is padded and sliced back)::

    python tools/torch_serve_batch.py -a flagship.liftreg \
        -i /data/cases -o /data/out

Case layout, as ``tools/serve_batch.py`` reads it: ``<id>_source.npy`` and
``<id>_target.npy`` HU volumes (D, W, H) or (1, D, W, H), with optional
``<id>_source_seg.npy`` / ``<id>_target_seg.npy`` masks. For a CT-free
artifact (``--entry projections`` at export) the target is
``<id>_target_proj.npy``, (P, pw, ph) normalized projections, and no
target volume or target mask is read. Writes ``<id>_warped.npy`` and
``<id>_phi.npy``, phi rescaled to [0, 1] as every ``_phi.npy`` of the
repository (``utils/io_utils.save_deformations``), so the output
directory is scored by ``utils/tre.eval_copd_highres`` as it is.

Serves on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_cases(input_dir, target_suffix="_target.npy"):
    ids = sorted(f[:-len("_source.npy")] for f in os.listdir(input_dir)
                 if f.endswith("_source.npy"))
    return [i for i in ids
            if os.path.exists(os.path.join(input_dir, i + target_suffix))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-a", "--artifact", required=True)
    ap.add_argument("-i", "--input", required=True,
                    help="directory of <id>_source.npy / <id>_target.npy")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--device", default=None,
                    help="'cpu' serves on the CPU; default the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np

    from liftreg_tpu_torch.serving import ServingModel

    srv = ServingModel.load(args.artifact, device=args.device)
    sz = srv.img_sz
    os.makedirs(args.out, exist_ok=True)

    def load_vol(path):
        v = np.load(path).astype(np.float32)
        if v.ndim == 3:
            v = v[None]
        if v.shape[-3:] != sz:
            raise ValueError(f"{path}: shape {v.shape[-3:]} != artifact "
                             f"img_sz {sz}")
        return v                                      # (1, D, W, H)

    def seg_or_ones(cid, which):
        path = os.path.join(args.input, f"{cid}_{which}_seg.npy")
        return load_vol(path) if os.path.exists(path) \
            else np.ones((1,) + sz, np.float32)

    ct_free = srv.entry == "register_projections"
    target_suffix = "_target_proj.npy" if ct_free else "_target.npy"
    ids = find_cases(args.input, target_suffix)
    if not ids:
        print(f"no cases found in {args.input} (need <id>_source.npy + "
              f"<id>{target_suffix})", file=sys.stderr)
        return 1
    print(f"{len(ids)} case(s), artifact batch {srv.batch_size}, entry "
          f"{srv.entry}, device {srv.device}")
    done = 0
    for start in range(0, len(ids), srv.batch_size):
        chunk = ids[start:start + srv.batch_size]
        src = np.stack([load_vol(os.path.join(args.input, f"{i}_source.npy"))
                        for i in chunk])
        sseg = np.stack([seg_or_ones(i, "source") for i in chunk])
        if ct_free:
            proj = np.stack([np.load(os.path.join(
                args.input, i + target_suffix)).astype(np.float32)
                for i in chunk])
            warped, phi = srv.register_projections(src, proj, sseg)
        else:
            tgt = np.stack([load_vol(os.path.join(args.input,
                                                  i + target_suffix))
                            for i in chunk])
            tseg = np.stack([seg_or_ones(i, "target") for i in chunk])
            warped, phi = srv.register(src, tgt, sseg, tseg)
        warped = warped.cpu().numpy()
        # the repository's _phi.npy convention: [0, 1]
        phi = ((phi + 1.0) / 2.0).cpu().numpy()
        for k, cid in enumerate(chunk):
            np.save(os.path.join(args.out, f"{cid}_warped.npy"), warped[k])
            np.save(os.path.join(args.out, f"{cid}_phi.npy"), phi[k])
            done += 1
        print(f"  [{done}/{len(ids)}] {', '.join(chunk)}")
    print(f"wrote {done} registrations to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
