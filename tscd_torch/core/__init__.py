"""The streaming eval step of the port's models."""
