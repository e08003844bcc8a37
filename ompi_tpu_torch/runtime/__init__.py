"""Runtime of the port: rendezvous store, rte client, launcher, device
plane and instance state."""
