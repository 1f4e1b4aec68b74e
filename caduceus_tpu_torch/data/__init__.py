"""Pretraining data of the port: owned copies of `caduceus_tpu/data/`
(FASTA access, MLM masking, the resumable sampler, the hg38 loader, the
synthetic genomes) and the native loader's bindings."""
