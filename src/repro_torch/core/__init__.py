"""The LAD-TS scheduling core: diffusion machinery, networks, Adam, the
replay pool, the agents, the environment and the Algorithm-1 trainer
(port of ``repro.core``)."""
