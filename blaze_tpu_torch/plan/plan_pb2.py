# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: plan.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nplan.proto\x12\x0e\x62laze_tpu.plan\"\xde\x01\n\x08\x44\x61taType\x12&\n\x04kind\x18\x01 \x01(\x0e\x32\x18.blaze_tpu.plan.TypeKind\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\x12)\n\x07\x65lement\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12)\n\x07map_key\x18\x05 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x32\n\rstruct_fields\x18\x06 \x03(\x0b\x32\x1b.blaze_tpu.plan.SchemaField\"V\n\x0bSchemaField\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\'\n\x05\x64type\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x10\n\x08nullable\x18\x03 \x01(\x08\"5\n\x06Schema\x12+\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x1b.blaze_tpu.plan.SchemaField\"\xfb\x01\n\x0bScalarValue\x12\'\n\x05\x64type\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x0f\n\x07is_null\x18\x02 \x01(\x08\x12\x14\n\nbool_value\x18\x03 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x04 \x01(\x03H\x00\x12\x15\n\x0b\x66loat_value\x18\x05 \x01(\x01H\x00\x12\x16\n\x0cstring_value\x18\x06 \x01(\tH\x00\x12\x16\n\x0c\x62inary_value\x18\x07 \x01(\x0cH\x00\x12\x1a\n\x10\x64\x65\x63imal_unscaled\x18\x08 \x01(\x03H\x00\x12\x1b\n\x13\x64\x65\x63imal_unscaled_hi\x18\t \x01(\x03\x42\x07\n\x05value\"\x9d\n\n\x08\x45xprNode\x12+\n\x06\x63olumn\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ColumnRefH\x00\x12.\n\x07literal\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.ScalarValueH\x00\x12,\n\x06\x62inary\x18\x03 \x01(\x0b\x32\x1a.blaze_tpu.plan.BinaryExprH\x00\x12(\n\x04\x63\x61st\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.CastExprH\x00\x12\'\n\x03not\x18\x05 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNodeH\x00\x12+\n\x07is_null\x18\x06 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNodeH\x00\x12/\n\x0bis_not_null\x18\x07 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNodeH\x00\x12,\n\x08negative\x18\x08 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNodeH\x00\x12-\n\x07in_list\x18\t \x01(\x0b\x32\x1a.blaze_tpu.plan.InListExprH\x00\x12(\n\x04\x63\x61se\x18\n \x01(\x0b\x32\x18.blaze_tpu.plan.CaseExprH\x00\x12)\n\x07if_expr\x18\x0b \x01(\x0b\x32\x16.blaze_tpu.plan.IfExprH\x00\x12\x31\n\tscalar_fn\x18\x0c \x01(\x0b\x32\x1c.blaze_tpu.plan.ScalarFnExprH\x00\x12?\n\x10string_predicate\x18\r \x01(\x0b\x32#.blaze_tpu.plan.StringPredicateExprH\x00\x12(\n\x04like\x18\x0e \x01(\x0b\x32\x18.blaze_tpu.plan.LikeExprH\x00\x12@\n\x11get_indexed_field\x18\x0f \x01(\x0b\x32#.blaze_tpu.plan.GetIndexedFieldExprH\x00\x12\x38\n\rget_map_value\x18\x10 \x01(\x0b\x32\x1f.blaze_tpu.plan.GetMapValueExprH\x00\x12\x37\n\x0cnamed_struct\x18\x11 \x01(\x0b\x32\x1f.blaze_tpu.plan.NamedStructExprH\x00\x12\x37\n\x0cmake_decimal\x18\x12 \x01(\x0b\x32\x1f.blaze_tpu.plan.MakeDecimalExprH\x00\x12\x32\n\x0eunscaled_value\x18\x13 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNodeH\x00\x12;\n\x0e\x63heck_overflow\x18\x14 \x01(\x0b\x32!.blaze_tpu.plan.CheckOverflowExprH\x00\x12\x35\n\x0budf_wrapper\x18\x15 \x01(\x0b\x32\x1e.blaze_tpu.plan.UdfWrapperExprH\x00\x12=\n\x0fscalar_subquery\x18\x16 \x01(\x0b\x32\".blaze_tpu.plan.ScalarSubqueryExprH\x00\x12>\n\x10get_struct_field\x18\x17 \x01(\x0b\x32\".blaze_tpu.plan.GetStructFieldExprH\x00\x12-\n\x07row_num\x18\x18 \x01(\x0b\x32\x1a.blaze_tpu.plan.RowNumExprH\x00\x12\x39\n\x0f\x62ound_reference\x18\x19 \x01(\x0b\x32\x1e.blaze_tpu.plan.BoundReferenceH\x00\x42\x06\n\x04\x65xpr\"\x19\n\tColumnRef\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1f\n\x0e\x42oundReference\x12\r\n\x05index\x18\x01 \x01(\r\"\xb2\x01\n\nBinaryExpr\x12$\n\x02op\x18\x01 \x01(\x0e\x32\x18.blaze_tpu.plan.BinaryOp\x12&\n\x04left\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\'\n\x05right\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12-\n\x0bresult_type\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\"\\\n\x08\x43\x61stExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\'\n\x05\x64type\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\"p\n\nInListExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12(\n\x06values\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x0f\n\x07negated\x18\x03 \x01(\x08\"\xc8\x01\n\x08\x43\x61seExpr\x12\x33\n\x08\x62ranches\x18\x01 \x03(\x0b\x32!.blaze_tpu.plan.CaseExpr.WhenThen\x12+\n\telse_expr\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x1aZ\n\x08WhenThen\x12&\n\x04when\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12&\n\x04then\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\"\x8a\x01\n\x06IfExpr\x12+\n\tcondition\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12&\n\x04then\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12+\n\telse_expr\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\"\xa3\x01\n\x0cScalarFnExpr\x12*\n\x02\x66n\x18\x01 \x01(\x0e\x32\x1e.blaze_tpu.plan.ScalarFunction\x12\x10\n\x08\x65xt_name\x18\x02 \x01(\t\x12&\n\x04\x61rgs\x18\x03 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12-\n\x0bresult_type\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\"\xb7\x01\n\x13StringPredicateExpr\x12\x32\n\x02op\x18\x01 \x01(\x0e\x32&.blaze_tpu.plan.StringPredicateExpr.Op\x12\'\n\x05\x63hild\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x0f\n\x07pattern\x18\x03 \x01(\x0c\"2\n\x02Op\x12\x0f\n\x0bSTARTS_WITH\x10\x00\x12\r\n\tENDS_WITH\x10\x01\x12\x0c\n\x08\x43ONTAINS\x10\x02\"T\n\x08LikeExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x0f\n\x07pattern\x18\x02 \x01(\x0c\x12\x0e\n\x06\x65scape\x18\x03 \x01(\x0c\"j\n\x13GetIndexedFieldExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12*\n\x05index\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.ScalarValue\"d\n\x0fGetMapValueExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12(\n\x03key\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.ScalarValue\"L\n\x12GetStructFieldExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\r\n\x05index\x18\x02 \x01(\r\"y\n\x0fNamedStructExpr\x12\r\n\x05names\x18\x01 \x03(\t\x12(\n\x06values\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12-\n\x0bresult_type\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\"\\\n\x0fMakeDecimalExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\"^\n\x11\x43heckOverflowExpr\x12\'\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\"\xa4\x01\n\x0eUdfWrapperExpr\x12\x12\n\nserialized\x18\x01 \x01(\x0c\x12-\n\x0breturn_type\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x10\n\x08nullable\x18\x03 \x01(\x08\x12(\n\x06params\x18\x04 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x13\n\x0bresource_id\x18\x05 \x01(\t\"~\n\x12ScalarSubqueryExpr\x12\x12\n\nserialized\x18\x01 \x01(\x0c\x12-\n\x0breturn_type\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x10\n\x08nullable\x18\x03 \x01(\x08\x12\x13\n\x0bresource_id\x18\x04 \x01(\t\"\x0c\n\nRowNumExpr\"Z\n\x08SortTerm\x12&\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x11\n\tascending\x18\x02 \x01(\x08\x12\x13\n\x0bnulls_first\x18\x03 \x01(\x08\"\x9b\x01\n\x0b\x41ggExprNode\x12\'\n\x02\x66n\x18\x01 \x01(\x0e\x32\x1b.blaze_tpu.plan.AggFunction\x12&\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12-\n\x0bresult_type\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x0c\n\x04name\x18\x04 \x01(\t\"\xb2\x01\n\x0eWindowExprNode\x12\x31\n\x07\x62uiltin\x18\x01 \x01(\x0e\x32\x1e.blaze_tpu.plan.WindowFunctionH\x00\x12*\n\x03\x61gg\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.AggExprNodeH\x00\x12-\n\x0bresult_type\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.DataType\x12\x0c\n\x04name\x18\x04 \x01(\tB\x04\n\x02\x66n\"\xf9\t\n\x08PlanNode\x12\x34\n\nprojection\x18\x01 \x01(\x0b\x32\x1e.blaze_tpu.plan.ProjectionNodeH\x00\x12,\n\x06\x66ilter\x18\x02 \x01(\x0b\x32\x1a.blaze_tpu.plan.FilterNodeH\x00\x12\x37\n\x0cparquet_scan\x18\x03 \x01(\x0b\x32\x1f.blaze_tpu.plan.ParquetScanNodeH\x00\x12(\n\x04sort\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.SortNodeH\x00\x12<\n\x0fsort_merge_join\x18\x05 \x01(\x0b\x32!.blaze_tpu.plan.SortMergeJoinNodeH\x00\x12;\n\x0e\x62roadcast_join\x18\x06 \x01(\x0b\x32!.blaze_tpu.plan.BroadcastJoinNodeH\x00\x12Q\n\x1a\x62roadcast_nested_loop_join\x18\x07 \x01(\x0b\x32+.blaze_tpu.plan.BroadcastNestedLoopJoinNodeH\x00\x12&\n\x03\x61gg\x18\x08 \x01(\x0b\x32\x17.blaze_tpu.plan.AggNodeH\x00\x12*\n\x05union\x18\t \x01(\x0b\x32\x19.blaze_tpu.plan.UnionNodeH\x00\x12?\n\x10\x65mpty_partitions\x18\n \x01(\x0b\x32#.blaze_tpu.plan.EmptyPartitionsNodeH\x00\x12;\n\x0erename_columns\x18\x0b \x01(\x0b\x32!.blaze_tpu.plan.RenameColumnsNodeH\x00\x12*\n\x05limit\x18\x0c \x01(\x0b\x32\x19.blaze_tpu.plan.LimitNodeH\x00\x12\x33\n\nffi_reader\x18\r \x01(\x0b\x32\x1d.blaze_tpu.plan.FfiReaderNodeH\x00\x12?\n\x10\x63oalesce_batches\x18\x0e \x01(\x0b\x32#.blaze_tpu.plan.CoalesceBatchesNodeH\x00\x12,\n\x06\x65xpand\x18\x0f \x01(\x0b\x32\x1a.blaze_tpu.plan.ExpandNodeH\x00\x12,\n\x06window\x18\x10 \x01(\x0b\x32\x1a.blaze_tpu.plan.WindowNodeH\x00\x12\x30\n\x08generate\x18\x11 \x01(\x0b\x32\x1c.blaze_tpu.plan.GenerateNodeH\x00\x12;\n\x0eshuffle_writer\x18\x12 \x01(\x0b\x32!.blaze_tpu.plan.ShuffleWriterNodeH\x00\x12\x42\n\x12rss_shuffle_writer\x18\x13 \x01(\x0b\x32$.blaze_tpu.plan.RssShuffleWriterNodeH\x00\x12\x33\n\nipc_writer\x18\x14 \x01(\x0b\x32\x1d.blaze_tpu.plan.IpcWriterNodeH\x00\x12\x33\n\nipc_reader\x18\x15 \x01(\x0b\x32\x1d.blaze_tpu.plan.IpcReaderNodeH\x00\x12*\n\x05\x64\x65\x62ug\x18\x16 \x01(\x0b\x32\x19.blaze_tpu.plan.DebugNodeH\x00\x12\x37\n\x0cparquet_sink\x18\x17 \x01(\x0b\x32\x1f.blaze_tpu.plan.ParquetSinkNodeH\x00\x42\x06\n\x04node\"q\n\x0eProjectionNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\'\n\x05\x65xprs\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\r\n\x05names\x18\x03 \x03(\t\"c\n\nFilterNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12,\n\npredicates\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\"\xa6\x01\n\x0fPartitionedFile\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x13\n\x0brange_start\x18\x03 \x01(\x04\x12\x11\n\trange_end\x18\x04 \x01(\x04\x12\x35\n\x10partition_values\x18\x05 \x03(\x0b\x32\x1b.blaze_tpu.plan.ScalarValue\x12\x18\n\x10last_modified_ns\x18\x06 \x01(\x03\";\n\tFileGroup\x12.\n\x05\x66iles\x18\x01 \x03(\x0b\x32\x1f.blaze_tpu.plan.PartitionedFile\"\x81\x02\n\x0fParquetScanNode\x12-\n\nfile_group\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.FileGroup\x12+\n\x0b\x66ile_schema\x18\x02 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\x12\x12\n\nprojection\x18\x03 \x03(\r\x12\x30\n\x10partition_schema\x18\x04 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\x12\x34\n\x12pruning_predicates\x18\x05 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x16\n\x0e\x66s_resource_id\x18\x06 \x01(\t\"q\n\x08SortNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\'\n\x05terms\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.SortTerm\x12\x13\n\x0b\x66\x65tch_limit\x18\x03 \x01(\x03\"l\n\x06JoinOn\x12&\n\x04left\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\'\n\x05right\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x11\n\tnull_safe\x18\x03 \x01(\x08\"\xac\x02\n\x11SortMergeJoinNode\x12&\n\x04left\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\'\n\x05right\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\"\n\x02on\x18\x03 \x03(\x0b\x32\x16.blaze_tpu.plan.JoinOn\x12+\n\tjoin_type\x18\x04 \x01(\x0e\x32\x18.blaze_tpu.plan.JoinType\x12.\n\x0csort_options\x18\x05 \x03(\x0b\x32\x18.blaze_tpu.plan.SortTerm\x12-\n\x0bjoin_filter\x18\x06 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x16\n\x0e\x65xistence_name\x18\x07 \x01(\t\"\x93\x02\n\x11\x42roadcastJoinNode\x12&\n\x04left\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\'\n\x05right\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\"\n\x02on\x18\x03 \x03(\x0b\x32\x16.blaze_tpu.plan.JoinOn\x12+\n\tjoin_type\x18\x04 \x01(\x0e\x32\x18.blaze_tpu.plan.JoinType\x12\x15\n\rbuild_is_left\x18\x05 \x01(\x08\x12-\n\x0bjoin_filter\x18\x06 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x16\n\x0e\x65xistence_name\x18\x07 \x01(\t\"\xc8\x01\n\x1b\x42roadcastNestedLoopJoinNode\x12&\n\x04left\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\'\n\x05right\x18\x02 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12+\n\tjoin_type\x18\x03 \x01(\x0e\x32\x18.blaze_tpu.plan.JoinType\x12+\n\tcondition\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\"\xc8\x01\n\x07\x41ggNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12%\n\x04mode\x18\x02 \x01(\x0e\x32\x17.blaze_tpu.plan.AggMode\x12*\n\x08grouping\x18\x03 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x16\n\x0egrouping_names\x18\x04 \x03(\t\x12)\n\x04\x61ggs\x18\x05 \x03(\x0b\x32\x1b.blaze_tpu.plan.AggExprNode\"5\n\tUnionNode\x12(\n\x06inputs\x18\x01 \x03(\x0b\x32\x18.blaze_tpu.plan.PlanNode\"U\n\x13\x45mptyPartitionsNode\x12&\n\x06schema\x18\x01 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\"M\n\x11RenameColumnsNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x0f\n\x07renamed\x18\x02 \x03(\t\"S\n\tLimitNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\r\n\x05limit\x18\x02 \x01(\x04\x12\x0e\n\x06global\x18\x03 \x01(\x08\"X\n\rFfiReaderNode\x12&\n\x06schema\x18\x01 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\x12\x1f\n\x17\x65xport_iter_resource_id\x18\x02 \x01(\t\"R\n\x13\x43oalesceBatchesNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x12\n\nbatch_size\x18\x02 \x01(\r\"\x8c\x01\n\nExpandNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12-\n\x0bprojections\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprList\x12&\n\x06schema\x18\x03 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\"3\n\x08\x45xprList\x12\'\n\x05\x65xprs\x18\x01 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\"\xc7\x01\n\nWindowNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x34\n\x0cwindow_exprs\x18\x02 \x03(\x0b\x32\x1e.blaze_tpu.plan.WindowExprNode\x12.\n\x0cpartition_by\x18\x03 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12*\n\x08order_by\x18\x04 \x03(\x0b\x32\x18.blaze_tpu.plan.SortTerm\"\x85\x02\n\x0cGenerateNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12/\n\x04kind\x18\x02 \x01(\x0e\x32!.blaze_tpu.plan.GenerateNode.Kind\x12,\n\nchild_expr\x18\x03 \x01(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x18\n\x10required_columns\x18\x04 \x03(\r\x12\x1e\n\x16generator_output_names\x18\x05 \x03(\t\x12\r\n\x05outer\x18\x06 \x01(\x08\"$\n\x04Kind\x12\x0b\n\x07\x45XPLODE\x10\x00\x12\x0f\n\x0bPOS_EXPLODE\x10\x01\"\xb4\x01\n\x0fHashRepartition\x12\x16\n\x0enum_partitions\x18\x01 \x01(\r\x12&\n\x04keys\x18\x02 \x03(\x0b\x32\x18.blaze_tpu.plan.ExprNode\x12\x32\n\x04kind\x18\x03 \x01(\x0e\x32$.blaze_tpu.plan.HashRepartition.Kind\"-\n\x04Kind\x12\x08\n\x04HASH\x10\x00\x12\n\n\x06SINGLE\x10\x01\x12\x0f\n\x0bROUND_ROBIN\x10\x02\"\x9a\x01\n\x11ShuffleWriterNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x35\n\x0cpartitioning\x18\x02 \x01(\x0b\x32\x1f.blaze_tpu.plan.HashRepartition\x12\x11\n\tdata_file\x18\x03 \x01(\t\x12\x12\n\nindex_file\x18\x04 \x01(\t\"\x96\x01\n\x14RssShuffleWriterNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x35\n\x0cpartitioning\x18\x02 \x01(\x0b\x32\x1f.blaze_tpu.plan.HashRepartition\x12\x1e\n\x16rss_writer_resource_id\x18\x03 \x01(\t\"V\n\rIpcWriterNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x1c\n\x14\x63onsumer_resource_id\x18\x02 \x01(\t\"s\n\rIpcReaderNode\x12&\n\x06schema\x18\x01 \x01(\x0b\x32\x16.blaze_tpu.plan.Schema\x12\x1c\n\x14provider_resource_id\x18\x02 \x01(\t\x12\x16\n\x0enum_partitions\x18\x04 \x01(\rJ\x04\x08\x03\x10\x04\"F\n\tDebugNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x10\n\x08\x64\x65\x62ug_id\x18\x02 \x01(\t\"\x9f\x01\n\x0fParquetSinkNode\x12\'\n\x05input\x18\x01 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode\x12\x16\n\x0e\x66s_resource_id\x18\x02 \x01(\t\x12\x0c\n\x04path\x18\x03 \x01(\t\x12\x16\n\x0erow_group_rows\x18\x04 \x01(\r\x12%\n\x05props\x18\x05 \x03(\x0b\x32\x16.blaze_tpu.plan.PropKV\"$\n\x06PropKV\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"q\n\x0eTaskDefinition\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x10\n\x08stage_id\x18\x02 \x01(\r\x12\x14\n\x0cpartition_id\x18\x03 \x01(\r\x12&\n\x04plan\x18\x04 \x01(\x0b\x32\x18.blaze_tpu.plan.PlanNode*\xf9\x01\n\x08TypeKind\x12\x0b\n\x07TK_NULL\x10\x00\x12\x0b\n\x07TK_BOOL\x10\x01\x12\x0b\n\x07TK_INT8\x10\x02\x12\x0c\n\x08TK_INT16\x10\x03\x12\x0c\n\x08TK_INT32\x10\x04\x12\x0c\n\x08TK_INT64\x10\x05\x12\x0e\n\nTK_FLOAT32\x10\x06\x12\x0e\n\nTK_FLOAT64\x10\x07\x12\r\n\tTK_STRING\x10\x08\x12\r\n\tTK_BINARY\x10\t\x12\r\n\tTK_DATE32\x10\n\x12\x17\n\x13TK_TIMESTAMP_MICROS\x10\x0b\x12\x0e\n\nTK_DECIMAL\x10\x0c\x12\x0b\n\x07TK_LIST\x10\r\x12\n\n\x06TK_MAP\x10\x0e\x12\r\n\tTK_STRUCT\x10\x0f*\xa7\x02\n\x08\x42inaryOp\x12\n\n\x06OP_ADD\x10\x00\x12\n\n\x06OP_SUB\x10\x01\x12\n\n\x06OP_MUL\x10\x02\x12\n\n\x06OP_DIV\x10\x03\x12\n\n\x06OP_MOD\x10\x04\x12\t\n\x05OP_EQ\x10\x05\x12\n\n\x06OP_NEQ\x10\x06\x12\t\n\x05OP_LT\x10\x07\x12\t\n\x05OP_LE\x10\x08\x12\t\n\x05OP_GT\x10\t\x12\t\n\x05OP_GE\x10\n\x12\n\n\x06OP_AND\x10\x0b\x12\t\n\x05OP_OR\x10\x0c\x12\x12\n\x0eOP_EQ_NULLSAFE\x10\r\x12\x0e\n\nOP_BIT_AND\x10\x0e\x12\r\n\tOP_BIT_OR\x10\x0f\x12\x0e\n\nOP_BIT_XOR\x10\x10\x12\x11\n\rOP_SHIFT_LEFT\x10\x11\x12\x12\n\x0eOP_SHIFT_RIGHT\x10\x12\x12\r\n\tOP_SC_AND\x10\x13\x12\x0c\n\x08OP_SC_OR\x10\x14*\xfe\x08\n\x0eScalarFunction\x12\x0e\n\nFN_UNKNOWN\x10\x00\x12\n\n\x06\x46N_ABS\x10\x01\x12\x0b\n\x07\x46N_ACOS\x10\x02\x12\x0b\n\x07\x46N_ASIN\x10\x03\x12\x0b\n\x07\x46N_ATAN\x10\x04\x12\x0c\n\x08\x46N_ATAN2\x10\x05\x12\x0b\n\x07\x46N_CEIL\x10\x06\x12\n\n\x06\x46N_COS\x10\x07\x12\n\n\x06\x46N_EXP\x10\x08\x12\x0c\n\x08\x46N_FLOOR\x10\t\x12\t\n\x05\x46N_LN\x10\n\x12\n\n\x06\x46N_LOG\x10\x0b\x12\x0c\n\x08\x46N_LOG10\x10\x0c\x12\x0b\n\x07\x46N_LOG2\x10\r\x12\n\n\x06\x46N_POW\x10\x0e\x12\x0c\n\x08\x46N_ROUND\x10\x0f\x12\r\n\tFN_SIGNUM\x10\x10\x12\n\n\x06\x46N_SIN\x10\x11\x12\x0b\n\x07\x46N_SQRT\x10\x12\x12\n\n\x06\x46N_TAN\x10\x13\x12\x0c\n\x08\x46N_TRUNC\x10\x14\x12\x0f\n\x0b\x46N_COALESCE\x10\x15\x12\r\n\tFN_NULLIF\x10\x16\x12\x0c\n\x08\x46N_ISNAN\x10\x17\x12\x0c\n\x08\x46N_NANVL\x10\x18\x12\x0c\n\x08\x46N_ASCII\x10\x19\x12\x11\n\rFN_BIT_LENGTH\x10\x1a\x12\x0c\n\x08\x46N_BTRIM\x10\x1b\x12\x12\n\x0e\x46N_CHAR_LENGTH\x10\x1c\x12\n\n\x06\x46N_CHR\x10\x1d\x12\r\n\tFN_CONCAT\x10\x1e\x12\x10\n\x0c\x46N_CONCAT_WS\x10\x1f\x12\x0e\n\nFN_INITCAP\x10 \x12\x0b\n\x07\x46N_LEFT\x10!\x12\x0c\n\x08\x46N_LOWER\x10\"\x12\x0b\n\x07\x46N_LPAD\x10#\x12\x0c\n\x08\x46N_LTRIM\x10$\x12\x13\n\x0f\x46N_OCTET_LENGTH\x10%\x12\r\n\tFN_REPEAT\x10&\x12\x0e\n\nFN_REPLACE\x10\'\x12\x0e\n\nFN_REVERSE\x10(\x12\x0c\n\x08\x46N_RIGHT\x10)\x12\x0b\n\x07\x46N_RPAD\x10*\x12\x0c\n\x08\x46N_RTRIM\x10+\x12\x11\n\rFN_SPLIT_PART\x10,\x12\x12\n\x0e\x46N_STARTS_WITH\x10-\x12\r\n\tFN_STRPOS\x10.\x12\r\n\tFN_SUBSTR\x10/\x12\r\n\tFN_TO_HEX\x10\x30\x12\x10\n\x0c\x46N_TRANSLATE\x10\x31\x12\x0b\n\x07\x46N_TRIM\x10\x32\x12\x0c\n\x08\x46N_UPPER\x10\x33\x12\x13\n\x0f\x46N_STRING_SPACE\x10\x34\x12\n\n\x06\x46N_MD5\x10\x35\x12\r\n\tFN_SHA224\x10\x36\x12\r\n\tFN_SHA256\x10\x37\x12\r\n\tFN_SHA384\x10\x38\x12\r\n\tFN_SHA512\x10\x39\x12\x0c\n\x08\x46N_CRC32\x10:\x12\x13\n\x0f\x46N_MURMUR3_HASH\x10;\x12\x13\n\x0f\x46N_NULL_IF_ZERO\x10<\x12\x15\n\x11\x46N_UNSCALED_VALUE\x10=\x12\x13\n\x0f\x46N_MAKE_DECIMAL\x10>\x12\x15\n\x11\x46N_CHECK_OVERFLOW\x10?\x12\x11\n\rFN_MAKE_ARRAY\x10@\x12\x16\n\x12\x46N_GET_JSON_OBJECT\x10\x41\x12\x11\n\rFN_PARSE_JSON\x10\x42\x12\x0f\n\x0b\x46N_DATE_ADD\x10\x43\x12\x0f\n\x0b\x46N_DATE_SUB\x10\x44\x12\x0f\n\x0b\x46N_DATEDIFF\x10\x45\x12\x0b\n\x07\x46N_YEAR\x10\x46\x12\x0c\n\x08\x46N_MONTH\x10G\x12\n\n\x06\x46N_DAY\x10H\x12\n\n\x06\x46N_EXT\x10\x64*\xa6\x01\n\x0b\x41ggFunction\x12\x0b\n\x07\x41GG_MIN\x10\x00\x12\x0b\n\x07\x41GG_MAX\x10\x01\x12\x0b\n\x07\x41GG_SUM\x10\x02\x12\x0b\n\x07\x41GG_AVG\x10\x03\x12\r\n\tAGG_COUNT\x10\x04\x12\r\n\tAGG_FIRST\x10\x05\x12\x1a\n\x16\x41GG_FIRST_IGNORES_NULL\x10\x06\x12\x14\n\x10\x41GG_COLLECT_LIST\x10\x07\x12\x13\n\x0f\x41GG_COLLECT_SET\x10\x08*@\n\x07\x41ggMode\x12\x0f\n\x0b\x41GG_PARTIAL\x10\x00\x12\x15\n\x11\x41GG_PARTIAL_MERGE\x10\x01\x12\r\n\tAGG_FINAL\x10\x02*F\n\x0eWindowFunction\x12\x12\n\x0eWIN_ROW_NUMBER\x10\x00\x12\x0c\n\x08WIN_RANK\x10\x01\x12\x12\n\x0eWIN_DENSE_RANK\x10\x02*\x84\x01\n\x08JoinType\x12\x0e\n\nJOIN_INNER\x10\x00\x12\r\n\tJOIN_LEFT\x10\x01\x12\x0e\n\nJOIN_RIGHT\x10\x02\x12\r\n\tJOIN_FULL\x10\x03\x12\x12\n\x0eJOIN_LEFT_SEMI\x10\x04\x12\x12\n\x0eJOIN_LEFT_ANTI\x10\x05\x12\x12\n\x0eJOIN_EXISTENCE\x10\x06\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'plan_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TYPEKIND._serialized_start=9958
  _TYPEKIND._serialized_end=10207
  _BINARYOP._serialized_start=10210
  _BINARYOP._serialized_end=10505
  _SCALARFUNCTION._serialized_start=10508
  _SCALARFUNCTION._serialized_end=11658
  _AGGFUNCTION._serialized_start=11661
  _AGGFUNCTION._serialized_end=11827
  _AGGMODE._serialized_start=11829
  _AGGMODE._serialized_end=11893
  _WINDOWFUNCTION._serialized_start=11895
  _WINDOWFUNCTION._serialized_end=11965
  _JOINTYPE._serialized_start=11968
  _JOINTYPE._serialized_end=12100
  _DATATYPE._serialized_start=31
  _DATATYPE._serialized_end=253
  _SCHEMAFIELD._serialized_start=255
  _SCHEMAFIELD._serialized_end=341
  _SCHEMA._serialized_start=343
  _SCHEMA._serialized_end=396
  _SCALARVALUE._serialized_start=399
  _SCALARVALUE._serialized_end=650
  _EXPRNODE._serialized_start=653
  _EXPRNODE._serialized_end=1962
  _COLUMNREF._serialized_start=1964
  _COLUMNREF._serialized_end=1989
  _BOUNDREFERENCE._serialized_start=1991
  _BOUNDREFERENCE._serialized_end=2022
  _BINARYEXPR._serialized_start=2025
  _BINARYEXPR._serialized_end=2203
  _CASTEXPR._serialized_start=2205
  _CASTEXPR._serialized_end=2297
  _INLISTEXPR._serialized_start=2299
  _INLISTEXPR._serialized_end=2411
  _CASEEXPR._serialized_start=2414
  _CASEEXPR._serialized_end=2614
  _CASEEXPR_WHENTHEN._serialized_start=2524
  _CASEEXPR_WHENTHEN._serialized_end=2614
  _IFEXPR._serialized_start=2617
  _IFEXPR._serialized_end=2755
  _SCALARFNEXPR._serialized_start=2758
  _SCALARFNEXPR._serialized_end=2921
  _STRINGPREDICATEEXPR._serialized_start=2924
  _STRINGPREDICATEEXPR._serialized_end=3107
  _STRINGPREDICATEEXPR_OP._serialized_start=3057
  _STRINGPREDICATEEXPR_OP._serialized_end=3107
  _LIKEEXPR._serialized_start=3109
  _LIKEEXPR._serialized_end=3193
  _GETINDEXEDFIELDEXPR._serialized_start=3195
  _GETINDEXEDFIELDEXPR._serialized_end=3301
  _GETMAPVALUEEXPR._serialized_start=3303
  _GETMAPVALUEEXPR._serialized_end=3403
  _GETSTRUCTFIELDEXPR._serialized_start=3405
  _GETSTRUCTFIELDEXPR._serialized_end=3481
  _NAMEDSTRUCTEXPR._serialized_start=3483
  _NAMEDSTRUCTEXPR._serialized_end=3604
  _MAKEDECIMALEXPR._serialized_start=3606
  _MAKEDECIMALEXPR._serialized_end=3698
  _CHECKOVERFLOWEXPR._serialized_start=3700
  _CHECKOVERFLOWEXPR._serialized_end=3794
  _UDFWRAPPEREXPR._serialized_start=3797
  _UDFWRAPPEREXPR._serialized_end=3961
  _SCALARSUBQUERYEXPR._serialized_start=3963
  _SCALARSUBQUERYEXPR._serialized_end=4089
  _ROWNUMEXPR._serialized_start=4091
  _ROWNUMEXPR._serialized_end=4103
  _SORTTERM._serialized_start=4105
  _SORTTERM._serialized_end=4195
  _AGGEXPRNODE._serialized_start=4198
  _AGGEXPRNODE._serialized_end=4353
  _WINDOWEXPRNODE._serialized_start=4356
  _WINDOWEXPRNODE._serialized_end=4534
  _PLANNODE._serialized_start=4537
  _PLANNODE._serialized_end=5810
  _PROJECTIONNODE._serialized_start=5812
  _PROJECTIONNODE._serialized_end=5925
  _FILTERNODE._serialized_start=5927
  _FILTERNODE._serialized_end=6026
  _PARTITIONEDFILE._serialized_start=6029
  _PARTITIONEDFILE._serialized_end=6195
  _FILEGROUP._serialized_start=6197
  _FILEGROUP._serialized_end=6256
  _PARQUETSCANNODE._serialized_start=6259
  _PARQUETSCANNODE._serialized_end=6516
  _SORTNODE._serialized_start=6518
  _SORTNODE._serialized_end=6631
  _JOINON._serialized_start=6633
  _JOINON._serialized_end=6741
  _SORTMERGEJOINNODE._serialized_start=6744
  _SORTMERGEJOINNODE._serialized_end=7044
  _BROADCASTJOINNODE._serialized_start=7047
  _BROADCASTJOINNODE._serialized_end=7322
  _BROADCASTNESTEDLOOPJOINNODE._serialized_start=7325
  _BROADCASTNESTEDLOOPJOINNODE._serialized_end=7525
  _AGGNODE._serialized_start=7528
  _AGGNODE._serialized_end=7728
  _UNIONNODE._serialized_start=7730
  _UNIONNODE._serialized_end=7783
  _EMPTYPARTITIONSNODE._serialized_start=7785
  _EMPTYPARTITIONSNODE._serialized_end=7870
  _RENAMECOLUMNSNODE._serialized_start=7872
  _RENAMECOLUMNSNODE._serialized_end=7949
  _LIMITNODE._serialized_start=7951
  _LIMITNODE._serialized_end=8034
  _FFIREADERNODE._serialized_start=8036
  _FFIREADERNODE._serialized_end=8124
  _COALESCEBATCHESNODE._serialized_start=8126
  _COALESCEBATCHESNODE._serialized_end=8208
  _EXPANDNODE._serialized_start=8211
  _EXPANDNODE._serialized_end=8351
  _EXPRLIST._serialized_start=8353
  _EXPRLIST._serialized_end=8404
  _WINDOWNODE._serialized_start=8407
  _WINDOWNODE._serialized_end=8606
  _GENERATENODE._serialized_start=8609
  _GENERATENODE._serialized_end=8870
  _GENERATENODE_KIND._serialized_start=8834
  _GENERATENODE_KIND._serialized_end=8870
  _HASHREPARTITION._serialized_start=8873
  _HASHREPARTITION._serialized_end=9053
  _HASHREPARTITION_KIND._serialized_start=9008
  _HASHREPARTITION_KIND._serialized_end=9053
  _SHUFFLEWRITERNODE._serialized_start=9056
  _SHUFFLEWRITERNODE._serialized_end=9210
  _RSSSHUFFLEWRITERNODE._serialized_start=9213
  _RSSSHUFFLEWRITERNODE._serialized_end=9363
  _IPCWRITERNODE._serialized_start=9365
  _IPCWRITERNODE._serialized_end=9451
  _IPCREADERNODE._serialized_start=9453
  _IPCREADERNODE._serialized_end=9568
  _DEBUGNODE._serialized_start=9570
  _DEBUGNODE._serialized_end=9640
  _PARQUETSINKNODE._serialized_start=9643
  _PARQUETSINKNODE._serialized_end=9802
  _PROPKV._serialized_start=9804
  _PROPKV._serialized_end=9840
  _TASKDEFINITION._serialized_start=9842
  _TASKDEFINITION._serialized_end=9955
# @@protoc_insertion_point(module_scope)
