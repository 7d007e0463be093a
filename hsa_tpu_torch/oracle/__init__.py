"""Ground-truth CPU oracle for output parity (counterpart of
:mod:`hsa_tpu.oracle`).

The direct implementation of the BWA-0.5.x-lineage branch-and-bound
semantics (SURVEY.md Appendix A) that the device engines must match record
for record (positions, strand, edit ops): the same search as the
reference's, so the card's records can be held against it where the
reference package does not run.
"""
