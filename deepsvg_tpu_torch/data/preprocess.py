"""Offline SVG simplification CLI, counterpart of
``deepsvg_tpu/data/preprocess.py``.

Usage::

    python -m deepsvg_tpu_torch.data.preprocess --data_folder svgs/ \\
        --output_folder svgs_simplified/ --output_meta_file svg_meta.csv

Per file: fill_(False) -> normalize -> zoom(0.9) -> canonicalize ->
simplify_heuristic -> save + meta row (id, total_len, nb_groups, len_groups,
max_len_group). The meta CSV is written with the ``csv`` module as pandas
writes it (``data/dataset.py:write_csv``), its rows in the order the files
finish. Parallelized with a process pool (``--workers`` > 1).
"""
from __future__ import annotations

import glob
import logging
import os
from argparse import ArgumentParser
from concurrent import futures

from ..svglib.svg import SVG
from .dataset import write_csv


def preprocess_svg(svg_file: str, output_folder: str) -> dict:
    filename = os.path.splitext(os.path.basename(svg_file))[0]

    svg = SVG.load_svg(svg_file)
    svg.fill_(False)
    svg.normalize()
    svg.zoom(0.9)
    svg.canonicalize()
    svg = svg.simplify_heuristic()

    svg.save_svg(os.path.join(output_folder, f"{filename}.svg"))

    len_groups = [g.total_len() for g in svg.svg_path_groups]
    return {
        "id": filename,
        "total_len": sum(len_groups),
        "nb_groups": len(len_groups),
        "len_groups": len_groups,
        "max_len_group": max(len_groups) if len_groups else 0,
    }


def run(args):
    svg_files = glob.glob(os.path.join(args.data_folder, "*.svg"))
    meta_rows = []
    executor_cls = (
        futures.ProcessPoolExecutor if args.workers > 1 else futures.ThreadPoolExecutor
    )
    with executor_cls(max_workers=args.workers) as executor:
        jobs = {
            executor.submit(preprocess_svg, f, args.output_folder): f for f in svg_files
        }
        for i, fut in enumerate(futures.as_completed(jobs)):
            try:
                meta_rows.append(fut.result())
            except Exception as e:  # keep going on malformed files
                logging.warning("failed on %s: %s", jobs[fut], e)
            if (i + 1) % 100 == 0:
                logging.info("processed %d/%d", i + 1, len(svg_files))

    write_csv(args.output_meta_file, meta_rows)
    logging.info("SVG preprocessing complete: %d files.", len(meta_rows))


def main(argv=None):
    """CLI entry (also the ``deepsvg-tpu-torch-preprocess`` console script)."""
    logging.basicConfig(level=logging.INFO)
    parser = ArgumentParser()
    parser.add_argument("--data_folder", default=os.path.join("dataset", "svgs"))
    parser.add_argument("--output_folder", default=os.path.join("dataset", "svgs_simplified"))
    parser.add_argument("--output_meta_file", default=os.path.join("dataset", "svg_meta.csv"))
    parser.add_argument("--workers", default=4, type=int)
    args = parser.parse_args(argv)

    os.makedirs(args.output_folder, exist_ok=True)
    run(args)


if __name__ == "__main__":
    main()
