"""The parallel paths of the port (the JAX package's ``parallel``): the
process glue (:mod:`.multiprocess`), the ("data", "model") mesh
(:mod:`.mesh`), the sharding rules and DDP / FSDP placement
(:mod:`.sharding`), tensor parallelism's cuts and collectives
(:mod:`.tensor`), and the commands' parallel launch (:mod:`.launch`)."""
