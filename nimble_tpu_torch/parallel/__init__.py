"""Multi-device execution on torch.distributed: the process-group mesh
(``mesh``), the k-mer table split by key hash over its model axis
(``sharded_index``), one rank's step of a sharded launch
(``sharded_fast``), and multi-host runs, each host with its own pipeline
(``multihost``)."""
