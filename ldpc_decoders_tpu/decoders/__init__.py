"""Batched decoders: BP (SPA/MSA), erasure SPA, ML, LP, ADMM, ADMMA."""
