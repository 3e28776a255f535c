"""Engine core: simulated time, random streams, event queues, kernels."""
