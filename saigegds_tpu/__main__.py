"""Command-line interface: fit / scan / aggregate / merge / info.

The reference is an R library; a CLI makes the workflow schedulable on
accelerator hosts (one shard per host, merge at the end):

    python -m saigegds_tpu fit --formula "y ~ x1 + x2" --pheno pheno.tsv \\
        --gds grm.gds --out model.npz [--dense] [--stream] [--checkpoint ck]
    python -m saigegds_tpu fit --formula "y ~ x1 + x2" --pheno-cols y1,y2 \\
        --pheno pheno.tsv --gds grm.gds --out model_{}.npz   # PheWAS fit
    python -m saigegds_tpu scan --gds imputed.gds --model model.npz \\
        --out assoc.gds [--mac 10] [--shard i/n]
    python -m saigegds_tpu burden|acat-v|acat-o --gds ... --model ... \\
        --win-size 10000 --win-shift 5000 --out out.gds
    python -m saigegds_tpu gxg --formula "y ~ x1 + x2" --pheno pheno.tsv \\
        --gds grm.gds --pairs pairs.tsv --out gxg.gds [--pair-batch 8]
    python -m saigegds_tpu merge --prefix out --out merged.parquet
    python -m saigegds_tpu info
"""

import argparse
import sys


# cells read as missing: pandas.read_csv's default na_values
NA_TOKENS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _read_pheno(path, id_col: str = "sample.id") -> dict:
    """Phenotype TSV/CSV (header row) -> {column: numpy array}.  The
    ``id_col`` column reads as strings; any other column of integers as
    int64, of numbers as float64, and of text as strings (a factor in
    the formula); :data:`NA_TOKENS` cells read as NaN or None — what the
    fit needs, without pandas."""
    import csv
    import gzip
    sep = "," if path.endswith(".csv") or path.endswith(".csv.gz") else "\t"
    with (gzip.open(path, "rt") if path.endswith(".gz")
          else open(path, newline="")) as fh:
        rows = list(csv.reader(fh, delimiter=sep))
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: _pheno_column(name, [r[j] for r in body],
                                text=name == id_col)
            for j, name in enumerate(header)}


def _pheno_column(name, cells, text=False):
    """One phenotype column; a mostly-numeric column with cells that are
    neither numbers nor missing-value tokens is an error, not a factor."""
    import numpy as np
    if text:
        return _text_column(cells)
    try:
        return np.asarray([int(c) for c in cells], np.int64)
    except ValueError:
        pass
    vals, bad, n_num = [], [], 0
    for c in cells:
        if c.strip() in NA_TOKENS:
            vals.append(np.nan)
            continue
        try:
            vals.append(float(c))
            n_num += 1
        except ValueError:
            bad.append(c)
    if not bad:
        return np.asarray(vals, np.float64)
    if n_num > len(bad):
        raise ValueError(
            f"phenotype column {name!r} is numeric but holds {len(bad)} "
            f"cell(s) that are neither numbers nor missing-value tokens, "
            f"e.g. {bad[0]!r}")
    return _text_column(cells)


def _text_column(cells):
    """Strings, with missing-value tokens as None (rows the fit drops)."""
    import numpy as np
    return np.asarray([None if c.strip() in NA_TOKENS else c
                       for c in cells], dtype=object)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="saigegds_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", help="fit the null GLMM (seqFitNullGLMM_SPA)")
    p.add_argument("--formula", required=True)
    p.add_argument("--pheno", required=True)
    p.add_argument("--gds", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--trait", default="binary",
                   choices=["binary", "quantitative"])
    p.add_argument("--dense", action="store_true",
                   help="dense f64 GRM operator (default: bf16-exact packed)")
    p.add_argument("--stream", action="store_true",
                   help="force out-of-core streamed ingestion (default: auto)")
    p.add_argument("--maf", type=float, default=0.005)
    p.add_argument("--missing-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=200)
    p.add_argument("--checkpoint", default="",
                   help="mid-fit checkpoint path prefix (resume on rerun)")
    p.add_argument("--var-ratio-mac-cat", default="",
                   help="comma-separated ascending MAC bin bounds (e.g. "
                        "'10.5,20.5') for MAC-categorized variance ratios "
                        "(opt-in newer-SAIGEgds feature; default pooled)")
    p.add_argument("--pheno-cols", default="",
                   help="comma-separated response columns for a PheWAS-mode "
                        "batched fit over ONE resident GRM (binary or "
                        "quantitative per --trait; --formula supplies the "
                        "shared covariates, its response is replaced; "
                        "--out then needs '{}')")

    for name, hlp in (("scan", "single-variant score+SPA scan"),
                      ("burden", "burden tests over sliding windows"),
                      ("acat-v", "ACAT-V tests"), ("acat-o", "ACAT-O tests")):
        q = sub.add_parser(name, help=hlp)
        q.add_argument("--gds", required=True)
        if name == "scan":
            q.add_argument("--model", required=True, action="append",
                           help="null model (npz/rds); repeat for a "
                                "PheWAS-mode multi-model scan sharing one "
                                "genotype pass (--out then needs '{}')")
        else:
            q.add_argument("--model", required=True)
        q.add_argument("--out", required=True)
        q.add_argument("--res-compress", default="LZMA",
                       choices=["LZMA", "LZMA_RA", "ZIP", "ZIP_RA", "none"],
                       help="result-file compression (gds pipes; rds/rda "
                            "stream, reference res.compress)")
        if name == "scan":
            q.add_argument("--mac", type=float, default=10.0)
            q.add_argument("--maf", type=float, default=float("nan"))
            q.add_argument("--shard", default="",
                           help="i/n: scan variant range i of n (0-based)")
            q.add_argument("--model-batch", type=int, default=0,
                           help="max models device-resident per genotype "
                                "pass (multi-model scans beyond ~32 "
                                "models at biobank N; 0 = all at once)")
            q.add_argument("--chr", default="",
                           help="restrict to chromosome(s), comma-separated")
            q.add_argument("--pos-range", default="",
                           help="restrict to lo:hi base-pair positions")
        else:
            q.add_argument("--win-size", type=int, default=10000)
            q.add_argument("--win-shift", type=int, default=5000)
            q.add_argument("--groups", default="",
                           help="gene-set units instead of sliding windows: "
                                "a JSON {set: [variant ids]} file or a "
                                "2-column TSV (set<TAB>variant id)")
            q.add_argument("--unit-shard", default="",
                           help="'i/n': run unit range i of n (multi-host; "
                                "merge the tables afterwards)")

    p = sub.add_parser(
        "gxg", help="SNP-pair GxG interaction tests (seqGLMM_GxG_spa)")
    p.add_argument("--formula", required=True)
    p.add_argument("--pheno", required=True)
    p.add_argument("--gds", required=True,
                   help="GRM genotype GDS (per-pair null refits)")
    p.add_argument("--pairs", required=True,
                   help="2-column TSV/CSV of variant-id pairs (header "
                        "optional; ids may be integers or strings)")
    p.add_argument("--out", required=True)
    p.add_argument("--assoc-gds", default="",
                   help="GDS holding the tested SNPs (default: --gds)")
    p.add_argument("--use-approx-tau", action="store_true",
                   help="reuse the base fit's tau instead of per-pair refits")
    p.add_argument("--glm-threshold", type=float, default=float("nan"),
                   help="plain-GLM screen p-value: pairs above it skip the "
                        "GLMM refit (reference's glm.threshold)")
    p.add_argument("--pair-batch", type=int, default=0,
                   help=">1: batch that many pairs per device dispatch")
    p.add_argument("--maf", type=float, default=0.005)
    p.add_argument("--missing-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=200)

    p = sub.add_parser("merge", help="row-bind result shards")
    p.add_argument("--prefix", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("vcf2gds", help="convert a VCF to a genotype GDS")
    p.add_argument("--vcf", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--field", default="GT", choices=["GT", "DS"],
                   help="GT hard calls or DS imputed dosages")
    p.add_argument("--split-multiallelic", action="store_true",
                   help="split multi-allelic rows into biallelic records")

    sub.add_parser("info", help="device/backend report")

    args = ap.parse_args(argv)

    from saigegds_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import saigegds_tpu as st
    from saigegds_tpu.config import AggregateConfig, NullModelConfig, ScanConfig

    if args.cmd == "info":
        print(st.device_info())
        return 0

    if args.cmd == "vcf2gds":
        from saigegds_tpu.io.vcf import vcf_to_gds
        n = vcf_to_gds(args.vcf, args.out, field=args.field,
                       split_multiallelic=args.split_multiallelic)
        print(f"wrote {n} variants -> {args.out}")
        return 0

    if args.cmd == "fit":
        pheno = _read_pheno(args.pheno)
        cfg = NullModelConfig(
            trait_type=args.trait, maf=args.maf,
            missing_rate=args.missing_rate, seed=args.seed,
            checkpoint=args.checkpoint,
            grm_impl="dense" if args.dense else "auto",
            stream_geno=True if args.stream else "auto",
            var_ratio_mac_cat=tuple(
                float(x) for x in args.var_ratio_mac_cat.split(",") if x))
        if args.pheno_cols:
            rhs = args.formula.split("~", 1)[1].strip()
            formulas = [f"{c.strip()} ~ {rhs}"
                        for c in args.pheno_cols.split(",") if c.strip()]
            models = st.fit_null_glmm_multi(formulas, pheno, args.gds, cfg,
                                            model_savefn=args.out,
                                            verbose=True)
            for m in models:
                print(m)
        else:
            model = st.fit_null_glmm(args.formula, pheno, args.gds, cfg,
                                     model_savefn=args.out, verbose=True)
            print(model)
        return 0

    if args.cmd == "scan":
        kwargs = {}
        from saigegds_tpu.io.seqarray import SeqData
        seq = SeqData(args.gds)
        if args.shard or args.chr or args.pos_range:
            import numpy as np
            mask = np.ones(seq.n_variants, bool)
            if args.shard:
                from saigegds_tpu.parallel.distributed import \
                    host_variant_range
                i, n = _parse_shard(args.shard)
                lo, hi = host_variant_range(seq.n_variants, i, n)
                shard = np.zeros(seq.n_variants, bool)
                shard[lo:hi] = True
                mask &= shard
            if args.chr or args.pos_range:
                mask &= seq.variant_selection(
                    chromosome=args.chr.split(",") if args.chr else None,
                    position_range=_parse_pos_range(args.pos_range)
                    if args.pos_range else None)
            kwargs["variant_mask"] = mask
        from saigegds_tpu.assoc.single import scan_table, scan_tables_multi
        if len(args.model) > 1:
            scan_tables_multi(seq, args.model,
                              ScanConfig(mac=args.mac, maf=args.maf),
                              res_savefn=args.out, verbose=True,
                              res_compress=args.res_compress,
                              model_batch=args.model_batch, **kwargs)
        else:
            scan_table(seq, args.model[0],
                       ScanConfig(mac=args.mac, maf=args.maf),
                       res_savefn=args.out, verbose=True,
                       res_compress=args.res_compress, **kwargs)
        return 0

    if args.cmd == "gxg":
        import math
        pheno = _read_pheno(args.pheno)
        pairs = _read_pairs(args.pairs)
        cfg = NullModelConfig(trait_type="binary", maf=args.maf,
                              missing_rate=args.missing_rate, seed=args.seed)
        tab = st.gxg_spa(
            args.formula, pheno, args.gds, pairs,
            gds_assoc=args.assoc_gds or None, config=cfg,
            use_approx_tau=args.use_approx_tau,
            glm_threshold=(False if math.isnan(args.glm_threshold)
                           else args.glm_threshold),
            res_savefn=args.out, verbose=True, pair_batch=args.pair_batch)
        print(f"gxg: {len(tab)} pairs -> {args.out}")
        return 0

    if args.cmd == "merge":
        from saigegds_tpu.parallel.distributed import merge_shards
        df = merge_shards(args.prefix)
        from saigegds_tpu.assoc.single import save_assoc
        save_assoc(df, args.out)
        print(f"merged {len(df)} rows -> {args.out}")
        return 0

    # aggregate commands
    from saigegds_tpu.assoc.aggregate import (acat_o_table, acat_v_table,
                                              burden_table, shard_units,
                                              sliding_windows,
                                              units_from_groups)
    from saigegds_tpu.io.seqarray import SeqData
    seq = SeqData(args.gds)
    if args.groups:
        groups = _read_groups(args.groups)
        units = units_from_groups(seq, groups)
    else:
        units = sliding_windows(seq, win_size=args.win_size,
                                win_shift=args.win_shift)
    if args.unit_shard:
        i, n = _parse_shard(args.unit_shard)
        units = shard_units(units, i, n)
    fn = {"burden": burden_table, "acat-v": acat_v_table,
          "acat-o": acat_o_table}[args.cmd]
    fn(seq, args.model, units, AggregateConfig(), res_savefn=args.out,
       res_compress=args.res_compress)
    print(f"{args.cmd}: {len(units)} units -> {args.out}")
    return 0


def _parse_shard(spec: str):
    """'i/n' with 0-based i in [0, n); friendly errors for the rest."""
    import sys
    try:
        i, n = (int(x) for x in spec.split("/"))
    except ValueError:
        sys.exit(f"--shard expects 'i/n' (0-based), got {spec!r}")
    if not (0 <= i < n):
        sys.exit(f"--shard index {i} outside [0, {n}) — shards are 0-based")
    return i, n


def _parse_pos_range(spec: str):
    import sys
    lo, _, hi = spec.partition(":")
    try:
        return (int(lo), int(hi))
    except ValueError:
        sys.exit(f"--pos-range expects 'lo:hi' base pairs, got {spec!r}")


def _read_pairs(path: str):
    """SNP-pair file -> 2-column DataFrame.  TSV or CSV; a header row is
    auto-detected (a first line whose two leading fields both parse as
    numbers is data, not a header)."""
    import pandas as pd
    sep = "," if path.endswith(".csv") or path.endswith(".csv.gz") else "\t"
    with (__import__("gzip").open(path, "rt") if path.endswith(".gz")
          else open(path)) as fh:
        first = fh.readline().strip().split(sep)

    def _is_num(s):
        try:
            float(s)
            return True
        except ValueError:
            return False
    header = None if (len(first) >= 2 and _is_num(first[0])
                      and _is_num(first[1])) else 0
    df = pd.read_csv(path, sep=sep, header=header)
    if df.shape[1] < 2:
        sys.exit(f"--pairs expects >=2 columns of variant ids, got "
                 f"{df.shape[1]} in {path!r}")
    return df.iloc[:, :2]


def _read_groups(path: str) -> dict:
    """Gene-set units file: JSON {name: [ids]} or TSV name<TAB>variant id."""
    if path.endswith(".json"):
        import json
        with open(path) as fh:
            return json.load(fh)
    groups: dict = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, vid = line.split("\t")[:2]
            try:
                vid = int(vid)
            except ValueError:
                pass
            groups.setdefault(name, []).append(vid)
    return groups


if __name__ == "__main__":
    sys.exit(main())
