"""Model configurations the port serves (ConvNet specs)."""
