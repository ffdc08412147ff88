"""The port's randomized differential campaigns, each an entry point:

    python -m nimble_tpu_torch.fuzz.differential  (engines vs host oracle)
    python -m nimble_tpu_torch.fuzz.fastq         (FASTQ fast vs slow TSVs)
    python -m nimble_tpu_torch.fuzz.bam           (BAM fast vs slow bytes)

The ports of the JAX package's ``scripts/fuzz_{differential,fastq,bam}.py``
on the port's engines and oracles, on the card (``--device cuda``, the
default) or the CPU, with either walk kernel or both.  ``corpus`` draws
the JAX scripts' corpora from the same child seeds, ``campaign`` holds
what the three entries share (options, schedule, reproducer, the ranks of
a mesh), and ``cdbg_oracle`` is the colored de Bruijn graph oracle of the
repeat-rate campaign.
"""
