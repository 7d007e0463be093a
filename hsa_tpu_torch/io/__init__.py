"""Host I/O: FASTA/FASTQ readers, SAM writer, reference metadata."""
