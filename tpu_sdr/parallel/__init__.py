"""Parallelism layer: device meshes, halo exchange, sharded receive chains.

The reference's only concurrency is two host threads and a channel
(SURVEY.md §2); here the stream scales across devices: DP = vmapped
stations, SP = time-axis sharding with overlap-save halo exchange
(``ppermute``), TP = channel-sharded filter banks.
"""
