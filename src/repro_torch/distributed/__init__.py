"""The LM's sharding rules and device grids, the serving fleet's device
placement (`sharding`), the data-parallel collectives (`collectives`)
and the fleet's fault tolerance (`fault_tolerance`)."""
