"""The pieces of the reference's services that the sharded engine needs."""
