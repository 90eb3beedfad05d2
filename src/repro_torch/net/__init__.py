"""Packet-loss channel processes of the serving link."""
