"""Train checkpoints and PTQ artifacts on disk, in the reference's files."""
