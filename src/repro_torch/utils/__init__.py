"""Multi-process helpers of the port: sharding and spawning ranks."""
