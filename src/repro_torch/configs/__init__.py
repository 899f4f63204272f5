"""Model configurations of the port: the schema (`base`) and the
registry of the architectures ported so far (`registry`)."""
