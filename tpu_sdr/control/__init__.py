"""Device control plane: USB transport, register protocol, tuner drivers.

This is the host-side half of the framework (SURVEY.md §1 L1-L4): the
accelerator has no USB, so device bring-up, tuning, and sample acquisition run on the
host and feed the JAX data plane through tpu_sdr.stream.
"""
