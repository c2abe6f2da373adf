"""Process group, launch, sampler and the DDP wrap."""
