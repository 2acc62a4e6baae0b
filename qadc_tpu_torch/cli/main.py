"""qadc-torch: the port's command line (counterpart of qadc_tpu/cli/main.py).

The same nine commands, flags and output as the JAX package's `qadc`, with
the reference's executables behind them (README.md:138-146):
  flatdb_create            -> create-flat
  indexdb_create1/2 +
    external PQ training   -> create-index   (coarse k-means and PQ/OPQ
                              training on the residuals in one step)
  indexdb_create2          -> set-quantizer
  db_add                   -> add            (chunks read ahead by a thread)
  db_query                 -> query --adc-type adc
  db_query_4               -> query --adc-type qadc (default)
  split_vecs               -> split
  convert-quantizer.py     -> convert-quantizer
and `info` and `tune`.

`query` prints the reference's CSV (db_query.cpp:117-120,
db_query_4.cpp:387-390):
  r,recall,ma,adc_type[,keep],index_us,rotate_us,table_us,scan_us

Every command runs on the card unless it is given `--device cpu`. Training
draws from a torch.Generator seeded by `--seed`, so the indexes it trains
are not the JAX CLI's bit for bit; the index files are the same format, and
either CLI reads what the other writes.

    python -m qadc_tpu_torch.cli.main create-index learn.fvecs idx --opq
    qadc-torch query idx queries.fvecs gt.ivecs -m 24 -k 0.213 --device cpu
"""

from __future__ import annotations

import argparse
import sys


def _parse_sq(spec: str):
    """'16x4' -> (16, 4)."""
    try:
        m, b = spec.lower().split("x")
        return int(m), int(b)
    except ValueError:
        raise SystemExit(f"invalid --sq '{spec}', expected MxB like 16x4")


def _train(gen, x, spec: str, opq: bool):
    m, b = _parse_sq(spec)
    if opq:
        from qadc_tpu_torch.quantizers.opq import train_opq

        return train_opq(gen, x, m, b)
    from qadc_tpu_torch.quantizers.pq import train_pq

    return train_pq(gen, x, m, b)


def cmd_create_flat(args):
    from qadc_tpu_torch.core.tensors import as_generator, to_f32
    from qadc_tpu_torch.index.flat import FlatIndex
    from qadc_tpu_torch.io.checkpoint import save_index
    from qadc_tpu_torch.io.quantizer_files import load_quantizer_file
    from qadc_tpu_torch.io.vecs import load_vectors

    if args.quantizer:
        pq = load_quantizer_file(args.quantizer, args.device)
    else:
        if not args.train:
            raise SystemExit("need a quantizer file or --train LEARN_FILE")
        learn = to_f32(load_vectors(args.train), args.device)
        pq = _train(as_generator(args.seed, args.device), learn, args.sq, args.opq)
    save_index(args.index, FlatIndex.create(pq))
    print(f"created flat index at {args.index}", file=sys.stderr)


def cmd_create_index(args):
    """One-step IVF creation: coarse k-means, then PQ/OPQ on the residuals
    (the reference's indexdb_create1 -> external training -> indexdb_create2,
    README.md:220-260)."""
    from qadc_tpu_torch.core.tensors import as_generator, to_f32
    from qadc_tpu_torch.index.ivf import IVFIndex, train_coarse
    from qadc_tpu_torch.io.checkpoint import save_index
    from qadc_tpu_torch.io.vecs import load_vectors
    from qadc_tpu_torch.ops.knn import assign_nearest

    learn = to_f32(load_vectors(args.learn), args.device)
    gen = as_generator(args.seed, args.device)
    coarse = train_coarse(gen, learn, args.parts, balance_cap=args.balance_cap or None)
    print(f"coarse quantizer: {args.parts} cells", file=sys.stderr)
    nearest = coarse[assign_nearest(learn, coarse).long()]
    residuals = learn - nearest
    # Self-check (reference: indexdb_create1 check_residuals to 1e-5).
    err = float((nearest + residuals - learn).abs().max()) if len(learn) else 0.0
    if err > 1e-5:
        raise SystemExit(f"residual check failed: {err}")
    if args.residuals_out:
        # For quantizer training elsewhere (the reference's indexdb_create1
        # residuals file, README.md:220-260).
        from qadc_tpu_torch.io.vecs import save_vectors

        save_vectors(args.residuals_out, residuals.cpu().numpy())
        print(f"residuals written to {args.residuals_out}", file=sys.stderr)
    if args.quantizer:
        # Trained elsewhere, typically on a --residuals-out file (the
        # reference's indexdb_create2).
        from qadc_tpu_torch.io.quantizer_files import load_quantizer_file

        pq = load_quantizer_file(args.quantizer, args.device)
        if pq.dim != learn.shape[1]:
            raise SystemExit(f"quantizer dim {pq.dim} != data dim {learn.shape[1]}")
    else:
        pq = _train(gen, residuals, args.sq, args.opq)
    save_index(args.index, IVFIndex.create(pq, coarse))
    print(f"created IVF index at {args.index}", file=sys.stderr)


def cmd_set_quantizer(args):
    """Install a quantizer trained elsewhere into an existing EMPTY index
    (reference: indexdb_create2, indexdb_create2.cpp:41-59)."""
    from qadc_tpu_torch.index import ivf
    from qadc_tpu_torch.index.flat import FlatIndex
    from qadc_tpu_torch.io.checkpoint import load_index, save_index
    from qadc_tpu_torch.io.quantizer_files import load_quantizer_file

    index = load_index(args.index, args.device)
    pq = load_quantizer_file(args.quantizer, args.device)
    if isinstance(index, FlatIndex):
        if index.n != 0:
            raise SystemExit(f"index is non-empty (n={index.n}); swap before adding vectors")
        if pq.dim != index.pq.dim:
            raise SystemExit(f"quantizer dim {pq.dim} != index dim {index.pq.dim}")
        new = FlatIndex.create(pq)
    else:
        try:
            new = ivf.set_quantizer(index, pq)
        except ValueError as e:
            raise SystemExit(str(e))
    save_index(args.out or args.index, new)
    print(f"installed quantizer {args.quantizer} into {args.out or args.index}",
          file=sys.stderr)


def cmd_add(args):
    from qadc_tpu_torch.eval.metrics import PhaseTimer
    from qadc_tpu_torch.index.build import FlatBuilder, IVFBuilder
    from qadc_tpu_torch.index.flat import FlatIndex
    from qadc_tpu_torch.io.checkpoint import load_index, save_index
    from qadc_tpu_torch.io.stream import VectorStream

    index = load_index(args.index, args.device)
    builder = (FlatBuilder.from_index(index) if isinstance(index, FlatIndex)
               else IVFBuilder.from_index(index))
    timer = PhaseTimer()
    for off, chunk in VectorStream(args.base, chunk_size=args.chunk_size):
        builder.add(chunk)
        print(f"added [{off}, {off + chunk.shape[0]}) in {timer.lap_us() / 1e6:.1f}s",
              file=sys.stderr)
    index = builder.finalize()
    save_index(args.index, index)
    print(f"index now holds {index.n} vectors", file=sys.stderr)


def cmd_query(args):
    from qadc_tpu_torch.engine import QueryEngine
    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.io.checkpoint import load_index
    from qadc_tpu_torch.io.vecs import load_vectors

    index = load_index(args.index, args.device)
    queries = load_vectors(args.queries)
    gt = load_vectors(args.groundtruth, to_float=False)
    keep = args.keep / 100.0  # the reference's -k is in percent (db_query_4.cpp:342)
    engine = QueryEngine(index, r=args.r, ma=args.ma, keep=keep, adc_type=args.adc_type,
                         batch_size=args.batch, rerank=not args.no_rerank)
    _, labels, metrics = engine.run(queries, with_metrics=True)
    recall = recall_at_r(labels, gt)
    if args.adc_type == "qadc":
        print(f"r,recall,ma,adc_type,keep,{metrics.HEADER}")
        print(f"{args.r},{recall},{args.ma},qadc,{keep},{metrics.csv_row()}")
    else:
        print(f"r,recall,ma,adc_type,{metrics.HEADER}")
        print(f"{args.r},{recall},{args.ma},adc,{metrics.csv_row()}")


def cmd_info(args):
    """Describe an index (reference: base_db::print / operator<<)."""
    from qadc_tpu_torch.index.ivf import IVFIndex
    from qadc_tpu_torch.io.checkpoint import load_index
    from qadc_tpu_torch.quantizers.opq import OPQQuantizer

    index = load_index(args.index, args.device)
    pq = index.pq
    kind = "opq" if isinstance(pq, OPQQuantizer) else "pq"
    print(f"type: {'ivf' if isinstance(index, IVFIndex) else 'flat'}")
    print(f"vectors: {index.n}")
    print(f"quantizer: {kind} (dim={pq.dim}, sq={pq.sq_count}x{pq.sq_bits}, "
          f"code_size={pq.code_size} bytes)")
    if isinstance(index, IVFIndex):
        sizes = index.part_sizes.cpu().numpy()
        nonempty = sizes[sizes > 0]
        print(f"partitions: {index.part_count} "
              f"(empty={int((sizes == 0).sum())}, "
              f"min={int(nonempty.min()) if nonempty.size else 0}, "
              f"mean={float(sizes.mean()):.0f}, max={int(sizes.max())}, "
              f"padded_to={index.part_pad})")


def cmd_tune(args):
    """Time and record the grouped Quick-ADC search's group size for an IVF
    index (qadc_tpu_torch/autotune.py). Later searches of any index of the
    same geometry on the same card use the pick (cache file:
    QADC_AUTOTUNE_CACHE, default ~/.cache/qadc_tpu_torch/autotune.json)."""
    import numpy as np

    from qadc_tpu_torch import autotune
    from qadc_tpu_torch.index.ivf import IVFIndex
    from qadc_tpu_torch.io.checkpoint import load_index
    from qadc_tpu_torch.io.vecs import load_vectors

    index = load_index(args.index, args.device)
    if not isinstance(index, IVFIndex):
        raise SystemExit("tune: only IVF indexes have tunable grouped scans")
    if args.queries:
        queries = load_vectors(args.queries)[: args.batch]
    else:
        rng = np.random.default_rng(0)
        queries = rng.normal(size=(args.batch, index.pq.dim)).astype(np.float32)
    pick = autotune.tune_ivf_qadc(index, queries, r=args.r, ma=args.ma,
                                  keep=args.keep / 100.0, verbose=True)
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    print(f"recorded {pick} under {key}")


def cmd_split(args):
    from qadc_tpu_torch.io.vecs import split_vecs

    split_vecs(args.input, args.output, args.chunk_id, args.chunk_size)


def cmd_convert_quantizer(args):
    """Convert pickled Quantizations codebooks to .pq.data / .opq.data
    (reference: convert-quantizer.py). Unpickling runs code from the file:
    convert only files you trust."""
    import pickle

    import numpy as np
    import torch

    from qadc_tpu_torch.io.quantizer_files import save_quantizer_file
    from qadc_tpu_torch.quantizers.opq import OPQQuantizer
    from qadc_tpu_torch.quantizers.pq import ProductQuantizer

    with open(args.input, "rb") as f:
        obj = pickle.load(f, encoding="latin1")
    if args.kind == "pq":
        codebooks = np.asarray(obj, np.float32)  # (m, k, dsq)
        pq = ProductQuantizer(centroids=torch.from_numpy(codebooks),
                              sq_bits=int(np.log2(codebooks.shape[1]))).validate()
    else:
        codebooks, rotation = obj
        codebooks = np.asarray(codebooks, np.float32)
        pq = OPQQuantizer(centroids=torch.from_numpy(codebooks),
                          sq_bits=int(np.log2(codebooks.shape[1])),
                          rotation=torch.from_numpy(np.asarray(rotation, np.float32))).validate()
    save_quantizer_file(args.output, pq)


def build_parser():
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="where the index lives and the work runs (default cuda; "
                        "cpu runs the kernels' plain PyTorch versions)")
    p = argparse.ArgumentParser(prog="qadc-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn, help_):
        c = sub.add_parser(name, help=help_, parents=[device])
        c.set_defaults(fn=fn)
        return c

    c = command("create-flat", cmd_create_flat, "create an empty flat index")
    c.add_argument("quantizer", nargs="?", help=".pq.data/.opq.data file")
    c.add_argument("index", help="output index directory")
    c.add_argument("--train", help="train a quantizer on this .fvecs instead")
    c.add_argument("--sq", default="16x4", help="sub-quantizers MxB (default 16x4)")
    c.add_argument("--opq", action="store_true", help="train OPQ instead of PQ")
    c.add_argument("--seed", type=int, default=0)

    c = command("create-index", cmd_create_index, "create an IVF index (one step)")
    c.add_argument("learn", help="learning set .fvecs")
    c.add_argument("index", help="output index directory")
    c.add_argument("--parts", type=int, default=256, help="IVF cells (default 256)")
    c.add_argument("--balance-cap", type=float, default=3.0,
                   help="bound the largest cell at this multiple of the mean (splits "
                   "oversized cells; every partition is padded to the largest; 0 "
                   "disables; default 3.0)")
    c.add_argument("--sq", default="16x4")
    c.add_argument("--opq", action="store_true")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--residuals-out", help="also write residuals as .fvecs "
                   "(for training elsewhere, reference indexdb_create1)")
    c.add_argument("--quantizer", help="use this pre-trained .pq.data/.opq.data instead "
                   "of training (reference indexdb_create2)")

    c = command("set-quantizer", cmd_set_quantizer,
                "swap an externally trained .pq.data/.opq.data into an existing "
                "empty index (reference indexdb_create2)")
    c.add_argument("index")
    c.add_argument("quantizer", help=".pq.data/.opq.data file")
    c.add_argument("--out", help="write to a new index path instead of in place")

    c = command("info", cmd_info, "describe an index")
    c.add_argument("index")

    c = command("add", cmd_add, "add base vectors to an index")
    c.add_argument("index")
    c.add_argument("base", help="base .fvecs/.bvecs")
    c.add_argument("--chunk-size", type=int, default=1_000_000)

    c = command("query", cmd_query, "query an index, print CSV metrics")
    c.add_argument("index")
    c.add_argument("queries", help="query .fvecs")
    c.add_argument("groundtruth", help="groundtruth .ivecs")
    c.add_argument("-r", type=int, default=100, dest="r")
    c.add_argument("-m", "--ma", type=int, default=1)
    c.add_argument("-k", "--keep", type=float, default=1.0, help="keep in PERCENT")
    c.add_argument("-b", "--batch", type=int, default=32)
    c.add_argument("--adc-type", choices=["adc", "qadc"], default="qadc")
    c.add_argument("--no-rerank", action="store_true",
                   help="reference-style ranking by quantized distance")

    c = command("tune", cmd_tune, "measure + record the group size for this geometry")
    c.add_argument("index")
    c.add_argument("--queries", default=None, help="fvecs/bvecs sample (default: synthetic)")
    c.add_argument("--batch", type=int, default=32)
    c.add_argument("-r", type=int, default=100, dest="r")
    c.add_argument("--ma", type=int, default=24)
    c.add_argument("--keep", type=float, default=0.213, help="percent, as in query")

    c = command("split", cmd_split, "extract a chunk of a vecs file")
    c.add_argument("chunk_id", type=int)
    c.add_argument("chunk_size", type=int)
    c.add_argument("input")
    c.add_argument("output")

    c = command("convert-quantizer", cmd_convert_quantizer, "pickle -> .pq.data/.opq.data")
    c.add_argument("kind", choices=["pq", "opq"])
    c.add_argument("input")
    c.add_argument("output")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
