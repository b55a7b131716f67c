"""The serving fleet's device placement (`sharding`) and its fault
tolerance (`fault_tolerance`)."""
