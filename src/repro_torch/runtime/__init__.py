"""Runtime policies of the port: fault tolerance and recovery."""
