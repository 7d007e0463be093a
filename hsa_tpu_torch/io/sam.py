"""SAM text emission (lineage: ``bwase.c:bwa_print_sam1`` + header)."""

from __future__ import annotations

from .fastx import RefMeta


def sam_header(meta: RefMeta, prog_args: str = "") -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, ln in zip(meta.names, meta.lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    lines.append("@PG\tID:hsa-tpu\tPN:hsa-tpu" + (f"\tCL:{prog_args}" if prog_args else ""))
    return "\n".join(lines) + "\n"


def write_sam(fh, meta: RefMeta, records, prog_args: str = ""):
    fh.write(sam_header(meta, prog_args))
    for rec in records:
        fh.write(rec.to_sam() + "\n")
