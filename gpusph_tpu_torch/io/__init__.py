"""Output of the port: VTU/legacy/text particle writers, the CommonWriter
scalar series, the writer dispatcher and hotfile checkpoints."""
