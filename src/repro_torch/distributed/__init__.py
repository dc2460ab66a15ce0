"""Distribution: the sharding rules and the mesh the port runs under."""
