"""UDP netstack: state, sockets, NIC, handler pipeline, build/run."""
